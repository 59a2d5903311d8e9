// K3: a fused chain of exact integer stages over planar uint8, the rank,
// nonlinear and registered-kernel family among them.
//
// Replaces the Pallas TPU kernel _chain_kernel (hipe_tpu/ops/pallas_blur.py:273,
// both variants: int32 networks and int16_ranks, blur.py:rank_stage_i16) on
// its planar entry, filter_chain_planar_pallas's non-MXU branch. The TPU
// kernel traces hipe_tpu/ops/blur.py's stage ops over whole planes in VMEM,
// keeping size^2 shifted window views live at once, and sizes its blocks by
// that liveness. Here each thread computes one pixel of one stage at a time
// from a window it reads out of shared memory, so no window view exists and
// the block size is the rows_per_block that the stream's autotune measures.
//
// Stages (one program entry each, any order, up to kMaxStages): every stage
// of K2 (gaussian 1..4, sharpen, edge, invert, solarize, posterize, LUT; the
// same run and walking forms, chain_lanes.cuh), and these (chain_lanes.cuh's
// forms and rank_stages.cuh's functors, shared with K5,
// tiled_stage_planar.cu):
//   median                 median of the 3x3 window (Paeth's min/max network)
//   erode, dilate          min, max of the 3x3 window
//   rank (size, rank)      rank-th smallest of the size x size window,
//                          size 3/5/7/9: PIL RankFilter, borders included
//   kernel (size, spec)    clip(floor((2 sum_ij t_ij x_ij + scale (off2 + 1))
//                          / (2 scale)), 0, 255), t the tap rows flipped as
//                          registered (ops/blur.py register_kernel_filter)
// Every stage clamps at the four edges of its own input; valid mode (h_pad
// = 0) returns rows [R, H - R) of the clamp-mode result, R the chain's total
// radius: _chain_kernel's clamp-then-trim rule.
//
// What bounds it on an H100: integer arithmetic, not device memory. A pass
// reads and writes the 983 MB stream once (~0.6 ms at the data sheet's
// 3.35 TB/s), but a size-9 rank stage does per pixel 81 shared-memory loads
// and 8 rounds of 81 compare-and-count, ~1.4k integer instructions, some
// 1.4 T over the 983 M pixels of the 5000-image stream: ~80 ms at the
// card's 64 int32 lanes a cycle on each of 132 SMs. The 3x3 stages of the
// denoise stream cost, in the first design (one byte a thread, a clamp on
// every tap, a division a byte), some 150 instructions a pixel: 7.79 ms;
// in the run-at-a-time one some 35, and 1.87 ms; walking bands of rows,
// 1.45 ms (NVIDIA H100 80GB HBM3, 700 W), 2.5x the stream's bytes bound.
//
// What the design does about it: it runs chain_lanes.cuh's skeleton, which
// K2's planar entry shares (one block per (plane, tile of rows_per_block
// rows), the input rows and halo staged in shared memory once, stages
// between two padded shared uint8 buffers whose pads hold each stage's own
// edge, so no tap clamps; a 2-D thread map of 8-byte runs; one read and one
// write a pass), and
// - computes the 3x3 median, erode and dilate eight outputs at a time from
//   per-column sorts and extrema in registers, with Hopper's three-input
//   min/max (DPX; the median two pixels a word in 16-bit lanes, walking a
//   band of rows as K2's gaussian3 and edge do, so each row is loaded and
//   unpacked once), and every K2 stage as K2 does;
// - selects a rank stage's value by bit-serial counting (the rank-th
//   smallest is >= c iff |{v < c}| <= rank; 8 rounds fix the 8 bits, most
//   significant first) over the window held in registers: no sort, no
//   branch, no spill, the same code for every rank and for sizes 3 to 9;
// - keeps a kernel stage's taps in registers too, loaded once a stage from
//   one int32 table in device memory, and divides exactly (the card has
//   integer division; C++ truncates toward zero, so the quotient is stepped
//   down once for a negative numerator with a remainder: a floor); these
//   two are rank_stages.cuh's per-pixel functors, reading the padded buffer;
// - is a separate kernel from K2, and instantiated for the widest window
//   of the program (3, 5, 7 or 9): a size-9 selection needs some 90
//   registers a thread, which would lower the occupancy of every band chain
//   in K2 and of every 3x3 chain here.
// The program travels by value as a kernel parameter; the host checks it
// and sizes shared memory from it, and refuses what it does not take.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "chain_lanes.cuh"
#include "chain_stages.cuh"
#include "rank_stages.cuh"

namespace {

constexpr int kMaxStages = 32;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

struct Program {
  int n_stages;
  int op[kMaxStages];
  int arg[kMaxStages];
  int size[kMaxStages];   // window edge of a rank or kernel stage
  int after[kMaxStages];  // Q_k: total radius of the stages after stage k
};

// One block per (plane, tile of rows_per_block output rows): chain_lanes.cuh's
// tile, as K2's planar entry. Output row o of a plane is plane row o +
// out_off (out_off = 0 clamp, R valid). Both buffers hold padded plane rows
// [g0 - R, g1 + R); the LUTs follow them. kMaxSize is the widest rank or
// kernel window the program holds; the 3x3 instantiation runs four blocks an
// SM, at 64 registers (the walking stages'), the wider ones as many as
// their windows' registers allow.
template <int kMaxSize>
__global__ void __launch_bounds__(kThreads, kMaxSize == 3 ? 4 : 1)
    rank_chain_planar_u8_kernel(const uint8_t* __restrict__ in,
                                uint8_t* __restrict__ out,
                                const uint8_t* __restrict__ luts, int n_luts,
                                const int* __restrict__ taps, int h, int w,
                                int ho, int out_off, int total_r,
                                int rows_per_block, int tiles, int vec_in, int vec_out,
                                Program prog) {
  extern __shared__ __align__(16) uint8_t smem16[];
  const lanes::Tile t(smem16, h, w, ho, out_off, total_r, rows_per_block, tiles);
  uint8_t* lut_s = t.tail();
  for (int i = threadIdx.x; i < n_luts * 256; i += kThreads) lut_s[i] = luts[i];
  const int r_in = total_r - prog.after[0];
  t.stage_input(in, max(t.base, -r_in), min(t.g1 + total_r, h + r_in), vec_in != 0);
  __syncthreads();

  for (int k = 0; k < prog.n_stages; ++k) {
    const int q = prog.after[k];
    const int r0 = max(t.g0 - q, 0);
    const int r1 = min(t.g1 + q, h);
    const bool last = k + 1 == prog.n_stages;
    const int rn = last ? 0 : q - prog.after[k + 1];  // the next stage's radius
#define HIPE_STAGE(f) t.stage(f, k, rn, last, r0, r1, out, vec_out != 0)
    const int arg = prog.arg[k];
    const int size = prog.size[k];
    switch (prog.op[k]) {
      case kGaussian:
        switch (arg) {
          case 1: HIPE_STAGE(lanes::Gaussian3Pairs{}); break;
          case 2: HIPE_STAGE(lanes::Gaussian<2>{}); break;
          case 3: HIPE_STAGE(lanes::Gaussian<3>{}); break;
          default: HIPE_STAGE(lanes::Gaussian<4>{}); break;
        }
        break;
      case kSharpen: HIPE_STAGE(lanes::SharpenPairs{}); break;
      case kEdge: HIPE_STAGE(lanes::EdgePairs{}); break;
      case kInvert: HIPE_STAGE(lanes::Invert{}); break;
      case kSolarize: HIPE_STAGE(lanes::Solarize{}); break;
      case kPosterize: HIPE_STAGE(lanes::Posterize{arg}); break;
      case kLut: HIPE_STAGE(lanes::Lut{lut_s + 256 * arg}); break;
      case kMedian: HIPE_STAGE(lanes::Median3Pairs{}); break;
      case kErode: HIPE_STAGE(lanes::Extreme3<false>{}); break;
      case kDilate: HIPE_STAGE(lanes::Extreme3<true>{}); break;
      case kRank:
        switch (size) {
          case 3: HIPE_STAGE(lanes::PerPixel<Rank<3>>{{arg}}); break;
          case 5:
            if constexpr (kMaxSize >= 5) HIPE_STAGE(lanes::PerPixel<Rank<5>>{{arg}});
            break;
          case 7:
            if constexpr (kMaxSize >= 7) HIPE_STAGE(lanes::PerPixel<Rank<7>>{{arg}});
            break;
          default:
            if constexpr (kMaxSize >= 9) HIPE_STAGE(lanes::PerPixel<Rank<9>>{{arg}});
            break;
        }
        break;
      default:  // kKernel
        switch (size) {
          case 3: HIPE_STAGE(lanes::PerPixel<Conv<3>>{Conv<3>(taps + arg)}); break;
          case 5:
            if constexpr (kMaxSize >= 5) {
              HIPE_STAGE(lanes::PerPixel<Conv<5>>{Conv<5>(taps + arg)});
            }
            break;
          case 7:
            if constexpr (kMaxSize >= 7) {
              HIPE_STAGE(lanes::PerPixel<Conv<7>>{Conv<7>(taps + arg)});
            }
            break;
          default:
            if constexpr (kMaxSize >= 9) {
              HIPE_STAGE(lanes::PerPixel<Conv<9>>{Conv<9>(taps + arg)});
            }
            break;
        }
        break;
    }
#undef HIPE_STAGE
    __syncthreads();
  }
}

using KernelFn = void (*)(const uint8_t*, uint8_t*, const uint8_t*, int, const int*, int,
                          int, int, int, int, int, int, int, int, Program);

int stage_radius(int op, int arg, int size) {
  switch (op) {
    case kGaussian: return arg;
    case kSharpen: case kEdge: case kMedian: case kErode: case kDilate: return 1;
    case kRank: case kKernel: return size / 2;
    default: return 0;
  }
}

bool stage_ok(int op, int arg, int size, int n_luts, int n_taps) {
  switch (op) {
    case kGaussian: return arg >= 1 && arg <= 4;
    case kSharpen: case kEdge: case kInvert: case kSolarize:
    case kMedian: case kErode: case kDilate: return true;
    case kPosterize: return arg >= 0 && arg <= 255;
    case kLut: return arg >= 0 && arg < n_luts;
    case kRank: return window_ok(size) && arg >= 0 && arg < size * size;
    case kKernel: return window_ok(size) && arg >= 0 && arg <= n_taps - 2 - size * size;
    default: return false;
  }
}

}  // namespace

// Run the n_stages-stage program (triples op, arg, size in host memory) over
// n planes of h x w uint8 from `in` into `out`: (n, h, w) with h_pad,
// (n, h - 2R, w) without, R the chain's total radius. `luts` holds n_luts
// tables of 256 bytes and `taps` n_taps int32 kernel-stage specs, both in
// device memory (either may be null when its count is 0). Launches on
// `stream`, does not synchronize and allocates nothing. Returns the
// cudaError_t of the launch as an int; a program it does not take (too many
// stages, an unknown op or argument, a tile beyond shared memory) is refused
// with an error and leaves no error behind for the next launch.
extern "C" int hipe_rank_chain_planar_u8(const void* in, void* out, int n, int h,
                                         int w, const int* program, int n_stages,
                                         const void* luts, int n_luts,
                                         const void* taps, int n_taps, int h_pad,
                                         int rows_per_block, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (program == nullptr || n_stages < 1 || n_stages > kMaxStages ||
      n_luts < 0 || (n_luts > 0 && luts == nullptr) || n_taps < 0 ||
      (n_taps > 0 && taps == nullptr)) {
    return invalid;
  }
  Program prog{};
  prog.n_stages = n_stages;
  int max_size = 3;
  for (int k = 0; k < n_stages; ++k) {
    prog.op[k] = program[3 * k];
    prog.arg[k] = program[3 * k + 1];
    prog.size[k] = program[3 * k + 2];
    if (!stage_ok(prog.op[k], prog.arg[k], prog.size[k], n_luts, n_taps)) return invalid;
    if (prog.op[k] == kRank || prog.op[k] == kKernel) {
      max_size = prog.size[k] > max_size ? prog.size[k] : max_size;
    }
  }
  int total_r = 0;
  for (int k = n_stages - 1; k >= 0; --k) {
    prog.after[k] = total_r;
    total_r += stage_radius(prog.op[k], prog.arg[k], prog.size[k]);
  }
  const int ho = h_pad ? h : h - 2 * total_r;
  if (n < 1 || h < 1 || w < 1 || ho < 1 || rows_per_block < 1 ||
      static_cast<long long>(h) * w > INT_MAX) {
    return invalid;
  }
  const int rpb = rows_per_block < ho ? rows_per_block : ho;
  const int tiles = (ho + rpb - 1) / rpb;
  const long long blocks = static_cast<long long>(n) * tiles;
  const long long smem =
      2LL * (rpb + 2 * total_r) * lanes::lane_pitch(w) + 256LL * n_luts;
  if (blocks > INT_MAX || smem > INT_MAX) return invalid;
  const KernelFn kernel = max_size == 3   ? rank_chain_planar_u8_kernel<3>
                          : max_size == 5 ? rank_chain_planar_u8_kernel<5>
                          : max_size == 7 ? rank_chain_planar_u8_kernel<7>
                                          : rank_chain_planar_u8_kernel<9>;
  if (smem > static_cast<long long>(kDefaultSharedBytes)) {
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
      static_cast<const uint8_t*>(luts), n_luts, static_cast<const int*>(taps), h, w, ho,
      h_pad ? 0 : total_r, total_r, rpb, tiles, vec_in, vec_out, prog);
  return static_cast<int>(cudaGetLastError());
}
