// K2: a fused chain of exact integer band and point stages over planar uint8.
//
// Replaces the Pallas TPU kernel _chain_mxu_kernel
// (hipe_tpu/ops/pallas_blur.py:923, both band forms: _mxu_stage, bf16 bands,
// and _mxu_stage_i8, int8 bands) on both its entries: planar
// (filter_chain_planar_pallas) and interleaved rows (filter_chain_rows_pallas,
// :902, (B, H, W*C) uint8, where the TPU kernel's bands take pixel stride C).
// The rows entry is a second kernel, chain_u8_kernel, with pixel stride C:
// a stage reads its taps at clamp(x + dx) * C + ch, so the edge clamps a
// whole pixel. The planar entry is chain_lanes_kernel.
// The TPU kernel folds each stage's W pass into a banded matrix for the
// matrix unit and rolls the H pass. Here every stage is the integer stencil
// or point op of hipe_tpu/ops/blur.py, summed directly: no band, no float.
//
// Stages (one program entry each, any order, up to kMaxStages):
//   gaussian r (r = 1..4)  (sum_ij C(2r,i) C(2r,j) x) >> 4r
//   sharpen                clip(5c - u - d - l - r, 0, 255)
//   edge                   min(|gx| + |gy|, 255), Sobel, gx across columns
//   invert, solarize       255 - x;  x >= 128 ? 255 - x : x
//   posterize              x & mask
//   lut k                  table k of the LUT array, gathered
// Every stage clamps at the four edges of its own input (clamp mode), so an
// intermediate is clamped at its own edge rows, as the TPU kernel clamps
// each stage of the whole plane. Valid mode (h_pad = 0) returns rows
// [R, H - R) of the clamp-mode result, R = the chain's total radius; there
// no H clamp ever bites, which is what hipe_tpu's valid-per-stage XLA path
// computes too.
//
// What bounds it on an H100: instruction issue, not device memory. One
// pass of the blur->sharpen->edge chain over the 5000-image 256x256 RGB
// stream reads 983 MB and writes 983 MB, ~0.59 ms at the data sheet's
// 3.35 TB/s. The first design (one byte a thread, a clamp on every tap, a
// division a byte, a 2-D gaussian) spent some 200 instructions a pixel on
// it: 9.18 ms a pass. The run-at-a-time design spent some 40 (staging,
// three stages of ~10-16 each, the stores): 2.12 ms (2.53 ms over 15000
// planes of 240x320). With the three stages walking bands of rows, some
// 33: 1.77 ms (2.14 ms at 240x320; NVIDIA H100 80GB HBM3, 700 W), 3.0x the
// bytes bound; by the count, issue is still most of that.
//
// What the design does about it: one read and one write a pass. A block
// owns (plane, tile of rows_per_block output rows); it stages the input
// rows the tile needs (R halo rows each side) in shared memory with 16-byte
// loads where the plane allows, then runs the stages one after another
// between two padded uint8 buffers in shared memory, so intermediates never
// leave the SM (the TPU kernel keeps them in VMEM). Stage k computes rows
// [y0 - Q_k, y1 + Q_k) clipped to the plane, Q_k being the radius of the
// stages after it; the last stage writes to device memory, 64 bits a store
// where aligned. The planar entry runs chain_lanes.cuh's skeleton: pads
// that hold each stage's own edge columns and rows, so no tap clamps; a
// 2-D thread map of 8-byte runs, so no division a byte; each stage's eight
// outputs from shared per-column values in registers (the gaussian
// separable, Sobel from column sums and differences, and gaussian3,
// sharpen and edge two pixels a 32-bit word in 16-bit lanes, each walking
// a band of rows so that every shared-memory row is loaded and unpacked
// once a thread, not three times); LUTs staged in shared memory. The rows entry keeps the first design (chain_stages.cuh's
// functors, any pixel stride). The program travels by value as a kernel
// parameter: the host checks it and sizes shared memory from it, and no
// copy precedes a launch. Output goes to a separate buffer: a tile's halo
// rows belong to its neighbour's tile, so writing in place would race.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "chain_lanes.cuh"
#include "chain_stages.cuh"

namespace {

constexpr int kMaxStages = 32;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

struct Program {
  int n_stages;
  int op[kMaxStages];
  int arg[kMaxStages];
  int after[kMaxStages];  // Q_k: total radius of the stages after stage k
};

// The rows entry: one block per (image, tile of rows_per_block output
// rows). Output row o of an image is row o + out_off (out_off = 0 clamp, R
// valid). Both shared buffers hold rows [g0 - R, g1 + R) at rows 0.. of the
// buffer. A row is w pixels of kC bytes (1: one channel; 0: c, any).
template <int kC>
__global__ void __launch_bounds__(kThreads)
    chain_u8_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    const uint8_t* __restrict__ luts, int h, int w, int c,
                    int ho, int out_off, int total_r, int rows_per_block,
                    int tiles, Program prog) {
  extern __shared__ uint8_t smem[];
  const int lanes = w * (kC > 0 ? kC : c);  // bytes a row
  const int buf_bytes = (rows_per_block + 2 * total_r) * lanes;
  uint8_t* bufs[2] = {smem, smem + buf_bytes};
  const int plane = blockIdx.x / tiles;
  const int g0 = (blockIdx.x - plane * tiles) * rows_per_block + out_off;
  const int g1 = min(g0 + rows_per_block, ho + out_off);
  const int base = g0 - total_r;

  // Stage the input rows [g0 - R, g1 + R) that lie in the plane.
  {
    const int a0 = max(base, 0);
    const int a1 = min(g1 + total_r, h);
    const int count = (a1 - a0) * lanes;
    const uint8_t* src = in + (static_cast<size_t>(plane) * h + a0) * lanes;
    uint8_t* dst = bufs[0] + (a0 - base) * lanes;
    for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
  }
  __syncthreads();

  uint8_t* plane_out = out + static_cast<size_t>(plane) * ho * lanes;
  int cur = 0;
  for (int k = 0; k < prog.n_stages; ++k) {
    const bool last = k == prog.n_stages - 1;
    const int q = prog.after[k];
    const int r0 = max(g0 - q, 0);
    const int r1 = min(g1 + q, h);
    const Src<kC> s{bufs[cur], lanes, h, base, w, 0, c};
    uint8_t* dst = last ? plane_out : bufs[cur ^ 1];
    const int dst_base = last ? out_off : base;
    const int arg = prog.arg[k];
    switch (prog.op[k]) {
      case kGaussian:
        switch (arg) {
          case 1: run_stage(Gaussian<1>{}, s, dst, dst_base, r0, r1); break;
          case 2: run_stage(Gaussian<2>{}, s, dst, dst_base, r0, r1); break;
          case 3: run_stage(Gaussian<3>{}, s, dst, dst_base, r0, r1); break;
          default: run_stage(Gaussian<4>{}, s, dst, dst_base, r0, r1); break;
        }
        break;
      case kSharpen: run_stage(Sharpen{}, s, dst, dst_base, r0, r1); break;
      case kEdge: run_stage(Edge{}, s, dst, dst_base, r0, r1); break;
      case kInvert: run_stage(Invert{}, s, dst, dst_base, r0, r1); break;
      case kSolarize: run_stage(Solarize{}, s, dst, dst_base, r0, r1); break;
      case kPosterize: run_stage(Posterize{arg}, s, dst, dst_base, r0, r1); break;
      default: run_stage(Lut{luts + 256 * arg}, s, dst, dst_base, r0, r1); break;
    }
    __syncthreads();
    cur ^= 1;
  }
}

// The planar entry: chain_lanes.cuh's tile, the same program. Both
// buffers hold padded plane rows [g0 - R, g1 + R); the LUTs follow them.
// Four blocks an SM: 64 registers a thread, what the walking stages need.
__global__ void __launch_bounds__(kThreads, 4)
    chain_lanes_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                       const uint8_t* __restrict__ luts, int n_luts, int h, int w, int ho,
                       int out_off, int total_r, int rows_per_block, int tiles, int vec_in,
                       int vec_out, Program prog) {
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
      default: HIPE_STAGE(lanes::Lut{lut_s + 256 * arg}); break;
    }
#undef HIPE_STAGE
    __syncthreads();
  }
}

int stage_radius(int op, int arg) {
  if (op == kGaussian) return arg;
  return (op == kSharpen || op == kEdge) ? 1 : 0;
}

bool stage_ok(int op, int arg, int n_luts) {
  switch (op) {
    case kGaussian: return arg >= 1 && arg <= 4;
    case kSharpen: case kEdge: case kInvert: case kSolarize: return true;
    case kPosterize: return arg >= 0 && arg <= 255;
    case kLut: return arg >= 0 && arg < n_luts;
    default: return false;
  }
}

int launch(const void* in, void* out, int n, int h, int w, int c,
           const int* program, int n_stages, const void* luts, int n_luts,
           int h_pad, int rows_per_block, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (program == nullptr || n_stages < 1 || n_stages > kMaxStages ||
      n_luts < 0 || (n_luts > 0 && luts == nullptr)) {
    return invalid;
  }
  Program prog{};
  prog.n_stages = n_stages;
  for (int k = 0; k < n_stages; ++k) {
    prog.op[k] = program[2 * k];
    prog.arg[k] = program[2 * k + 1];
    if (!stage_ok(prog.op[k], prog.arg[k], n_luts)) return invalid;
  }
  int total_r = 0;
  for (int k = n_stages - 1; k >= 0; --k) {
    prog.after[k] = total_r;
    total_r += stage_radius(prog.op[k], prog.arg[k]);
  }
  const int ho = h_pad ? h : h - 2 * total_r;
  if (n < 1 || h < 1 || w < 1 || c < 1 || ho < 1 || rows_per_block < 1 ||
      static_cast<long long>(h) * w * c > INT_MAX) {
    return invalid;
  }
  const int rpb = rows_per_block < ho ? rows_per_block : ho;
  const int tiles = (ho + rpb - 1) / rpb;
  const long long blocks = static_cast<long long>(n) * tiles;
  const long long smem = 2LL * (rpb + 2 * total_r) * w * c;
  if (blocks > INT_MAX || smem > INT_MAX) return invalid;
  const auto kernel = c == 1 ? chain_u8_kernel<1> : chain_u8_kernel<0>;
  if (smem > static_cast<long long>(kDefaultSharedBytes)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return static_cast<int>(e);
    }
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint8_t*>(luts), h, w, c, ho, h_pad ? 0 : total_r,
      total_r, rpb, tiles, prog);
  return static_cast<int>(cudaGetLastError());
}

// The planar entry's launch: the checks of launch(), chain_lanes.cuh's
// shared memory (two padded buffers and the LUTs), and the alignment of the
// input (16-byte loads) and output (a store a run).
int launch_planar(const void* in, void* out, int n, int h, int w, const int* program,
                  int n_stages, const void* luts, int n_luts, int h_pad, int rows_per_block,
                  void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (program == nullptr || n_stages < 1 || n_stages > kMaxStages ||
      n_luts < 0 || (n_luts > 0 && luts == nullptr)) {
    return invalid;
  }
  Program prog{};
  prog.n_stages = n_stages;
  for (int k = 0; k < n_stages; ++k) {
    prog.op[k] = program[2 * k];
    prog.arg[k] = program[2 * k + 1];
    if (!stage_ok(prog.op[k], prog.arg[k], n_luts)) return invalid;
  }
  int total_r = 0;
  for (int k = n_stages - 1; k >= 0; --k) {
    prog.after[k] = total_r;
    total_r += stage_radius(prog.op[k], prog.arg[k]);
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
  if (smem > static_cast<long long>(kDefaultSharedBytes)) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return static_cast<int>(e);
    }
  }
  const int vec_in = reinterpret_cast<uintptr_t>(in) % 16 == 0 && w % 16 == 0;
  const int vec_out =
      reinterpret_cast<uintptr_t>(out) % lanes::kRun == 0 && w % lanes::kRun == 0;
  chain_lanes_kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint8_t*>(luts), n_luts, h, w, ho, h_pad ? 0 : total_r, total_r, rpb,
      tiles, vec_in, vec_out, prog);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Run the n_stages-stage program (pairs op, arg in host memory) over n
// planes of h x w uint8 from `in` into `out`: (n, h, w) with h_pad,
// (n, h - 2R, w) without, R the chain's total radius. `luts` holds n_luts
// tables of 256 bytes in device memory (may be null when n_luts is 0).
// Launches on `stream`, does not synchronize and allocates nothing. Returns
// the cudaError_t of the launch as an int; a program it does not take (too
// many stages, an unknown op, a tile beyond shared memory) is refused with
// an error and leaves no error behind for the next launch.
extern "C" int hipe_chain_planar_u8(const void* in, void* out, int n, int h,
                                    int w, const int* program, int n_stages,
                                    const void* luts, int n_luts, int h_pad,
                                    int rows_per_block, void* stream) {
  return launch_planar(in, out, n, h, w, program, n_stages, luts, n_luts, h_pad,
                       rows_per_block, stream);
}

// The same over n images of interleaved rows, (n, h, w * c) uint8 with c
// channels a pixel: every stage reads its taps a whole pixel apart and
// clamps at the first and last pixel of a row.
extern "C" int hipe_chain_rows_u8(const void* in, void* out, int n, int h, int w,
                                  int c, const int* program, int n_stages,
                                  const void* luts, int n_luts, int h_pad,
                                  int rows_per_block, void* stream) {
  return launch(in, out, n, h, w, c, program, n_stages, luts, n_luts, h_pad,
                rows_per_block, stream);
}
