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
// and the range limit cost 25.5 (K6) and 23.27 (K7) int32 operations a
// sample (counted in chip_smoke.py), 0.37 and 0.34 ms at the CUDA cores'
// peak (64 lanes x 132 SMs x 1.98 GHz, two operations an instruction at
// most), and more in instructions issued: the int8 tensor cores do not
// apply, as the products exceed 24 bits.
//
// K6 (a first, simple design): 8 threads an 8x8 block, 32 blocks a thread
// block. The column pass runs in registers on a column a thread, one
// transpose goes through shared memory, and the row pass runs on a row a
// thread. Each thread reads its column's 8 coefficients (neighbouring
// groups read neighbouring blocks, so the 128-byte blocks are read once
// through L1) and stores its output row as 8 bytes. The quant table
// travels by value as a kernel parameter and is staged in shared memory,
// once a thread block.
//
// K7 (redesigned for Hopper): a thread an 8x8 block, in its registers:
// eight 8-byte row loads, the row pass, the column pass and the quantizer.
// So no transpose goes through shared memory and no thread block waits at a
// barrier, and every thread works on the same table position at the same
// time: the quantizer's per-position constants are warp-uniform kernel
// parameters, read from the constant bank. The quantizer divides by no
// runtime divisor (quantize(), with its exactness bound), and the level
// shift is one subtract a block (the DC: see the kernel). A 2-D grid puts
// the block row (b * Hb + by) in x and the block column in y, so the
// addressing divides by nothing either. A warp's loads cover whole runs of
// its blocks' rows (32 blocks: 256 contiguous bytes a row); its stores go
// through shared memory (its own 4.5 KB, ordered by __syncwarp), so that
// each store instruction writes 4 whole blocks, 512 contiguous bytes.
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

// K7's quantizer: jcdct.c's v = (|t| + qd/2) / qd for the divisor qd = q << 3
// of each table position, the sign put back (round half away from zero),
// without a division. With L = floor(log2 qd) (3..18 for q in 1..65535):
//   mul = ceil(2^(31+L) / qd), in (2^30, 2^31];  shift = L - 1;  half = qd >> 1,
// and for a = |t| + half, a / qd = umulhi(a, mul) >> shift: the high word
// of the 64-bit product and the shift floor twice, which is one floor of
// a * mul / 2^(31+L). Exact for every a < 2^30: write mul * qd = 2^(31+L) + e
// with 0 <= e < qd, and a = v * qd + r with 0 <= r < qd; then
//   a * mul / 2^(31+L) = v + (r + a * e / 2^(31+L)) / qd,
// and a * e < 2^30 * 2^(L+1) = 2^(31+L), so the fraction stays below 1.
// What a reaches: level-shifted samples lie in [-128, 127]. The row pass
// gives at most 4096 in magnitude (its DC, 8 * 128 << 2), the column pass at
// most 8192: the DC of a block of 0s, 64 * 128. No AC term passes 8160, the
// most any one reaches, on the block whose samples are 0 or 255 by the signs
// of its weights. So a <= 8192 + (65535 << 2) = 270332 < 2^19.
struct QuantTable {
  uint32_t mul[64];  // natural order
  uint32_t half[64];
  uint32_t shift[64];
};

__device__ __forceinline__ uint32_t quantize(int32_t t, uint32_t mul, uint32_t half,
                                             uint32_t shift) {
  const uint32_t mag = t < 0 ? 0u - static_cast<uint32_t>(t) : static_cast<uint32_t>(t);
  const uint32_t v = __umulhi(mag + half, mul) >> shift;
  return t < 0 ? 0u - v : v;
}

// K7's thread blocks: 128 threads, at least 6 of them an SM. That caps a
// thread at 80 registers, which it fits without a spill; left to itself the
// compiler takes 112 (4 thread blocks an SM) and runs 9% slower on the
// codec's stream, and at 7 (72 registers) it spills (dct_variants.py).
constexpr int kK7Threads = 128;
constexpr int kK7MinCtas = 6;
// The level shift. The row pass runs on the unshifted samples: -128 on each
// of them cancels in every output but the row's DC, which is 4096 too large
// ((8 * 128) << 2). In the column pass over those DCs the 4096 cancels in
// turn in every output but the block's DC, which is
// DESCALE(x + 8 * 4096, 2) = DESCALE(x, 2) + 8192 too large.
constexpr uint32_t kDcShift = 8192;

// K7. Thread (x, y) of thread block (X, Y) takes block column
// bx = Y' * blockDim.x + x (Y' = Y, Y + gridDim.y, ...) of block row
// band = X * blockDim.y + y, where band = b * Hb + by: input rows
// band * 8 + 0..7, columns bx * 8 + 0..7; output block band * Wb + bx.
__global__ void __launch_bounds__(kK7Threads, kK7MinCtas)
    fdct_quantize_kernel(const uint8_t* __restrict__ grid, int16_t* __restrict__ coefs,
                         const QuantTable qt, int bands, int wb, int tiles) {
  // The warp's coefficient rows, 16 bytes each, staged for whole-block stores.
  __shared__ uint4 stage[kK7Threads / 32][32][9];  // +1: no bank conflicts
  const int lin = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = lin & 31;
  uint4(*warp)[9] = stage[lin >> 5];
  const int band = blockIdx.x * blockDim.y + threadIdx.y;
  const size_t pitch = static_cast<size_t>(wb) * 8;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int bx = tile * blockDim.x + threadIdx.x;
    const bool live = band < bands && bx < wb;
    // One 8-byte load a row, all eight issued first.
    const uint8_t* src =
        grid + static_cast<size_t>(band) * 8 * pitch + static_cast<size_t>(bx) * 8;
    uint2 raw[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      raw[r] = live ? __ldg(reinterpret_cast<const uint2*>(src + r * pitch)) : make_uint2(0, 0);
    }
    // Row pass on each row.
    uint32_t ws[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      uint32_t d[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        d[k] = __byte_perm(raw[r].x, 0u, 0x4440u | k);
        d[k + 4] = __byte_perm(raw[r].y, 0u, 0x4440u | k);
      }
      int32_t row[8];
      fdct_1d<false>(d, row);
#pragma unroll
      for (int c = 0; c < 8; ++c) ws[r][c] = static_cast<uint32_t>(row[c]);
    }
    // Column pass on each column, quantize; two columns' int16 a word.
    uint32_t packed[8][4];
#pragma unroll
    for (int v = 0; v < 8; v += 2) {
      uint32_t qv[2][8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t d[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) d[r] = ws[r][v + j];
        int32_t col[8];
        fdct_1d<true>(d, col);
        if (v + j == 0) col[0] = static_cast<int32_t>(static_cast<uint32_t>(col[0]) - kDcShift);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int k = 8 * u + v + j;
          qv[j][u] = quantize(col[u], qt.mul[k], qt.half[k], qt.shift[k]);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) packed[u][v / 2] = __byte_perm(qv[0][u], qv[1][u], 0x5410u);
    }
    // Coefficient row u of the lane's block to row u of its slot. Then the
    // warp stores the 32 slots as 8 runs of 4 whole blocks, each lane one
    // 16-byte row, skipping blocks off the grid. (Each lane storing its own
    // block, 32 blocks 128 bytes apart an instruction, runs 1.8x slower:
    // dct_variants.py.)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      warp[lane][u] = make_uint4(packed[u][0], packed[u][1], packed[u][2], packed[u][3]);
    }
    const int blk = live ? band * wb + bx : -1;
    __syncwarp();
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int from = 4 * s + (lane >> 3);
      const int k = __shfl_sync(0xffffffffu, blk, from);
      if (k >= 0) {
        *reinterpret_cast<uint4*>(coefs + static_cast<size_t>(k) * 64 + (lane & 7) * 8) =
            warp[from][lane & 7];
      }
    }
    __syncwarp();
  }
}

bool make_table(const unsigned* qtable, QTable* qt) {
  for (int k = 0; k < 64; ++k) {
    if (qtable[k] < 1u || qtable[k] > 65535u) return false;
    qt->q[k] = qtable[k];
  }
  return true;
}

// K7's quant table: each position's divisor as quantize() takes it, or false
// unless every entry is in 1..65535.
bool make_quant_table(const unsigned* qtable, QuantTable* qt) {
  for (int k = 0; k < 64; ++k) {
    if (qtable[k] < 1u || qtable[k] > 65535u) return false;
    const uint32_t qd = qtable[k] << 3;
    uint32_t l = 0;
    while (qd >> (l + 1)) ++l;  // floor(log2 qd)
    qt->mul[k] = static_cast<uint32_t>(((1ull << (31 + l)) + qd - 1) / qd);
    qt->half[k] = qd >> 1;
    qt->shift[k] = l - 1;
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

// K7's launch: thread blocks of gx by 128 / gx threads, gx the least power of
// two >= wb up to 128; b * hb block rows over gridDim.x (up to 2^31 - 1),
// the wb / gx tiles of block columns over gridDim.y (up to 65535, the
// kernel walks the rest). False if the grid is out of range (as ctas_for).
struct K7Launch {
  dim3 grid, block;
  int bands, tiles;
};

bool k7_launch(int b, int hb, int wb, K7Launch* l) {
  if (ctas_for(b, hb, wb) == 0) return false;
  int gx = 1;
  while (gx < wb && gx < kK7Threads) gx <<= 1;
  const int gy = kK7Threads / gx;
  l->bands = b * hb;
  l->tiles = (wb + gx - 1) / gx;
  l->block = dim3(gx, gy);
  l->grid = dim3((l->bands + gy - 1) / gy, l->tiles < 65535 ? l->tiles : 65535);
  return true;
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
  QuantTable qt;
  K7Launch l;
  if (!k7_launch(b, hb, wb, &l) || !make_quant_table(qtable, &qt)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fdct_quantize_kernel<<<l.grid, l.block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(grid), static_cast<int16_t*>(coefs), qt, l.bands, wb, l.tiles);
  return static_cast<int>(cudaGetLastError());
}
