// K8, K9, K10: PIL ImageOps.equalize over planar (N, H, W) uint8 planes, a
// histogram, a table and a lookup a plane, in three kernels.
//
// Replaces no pallas_call: hipe_tpu's equalize (hipe_tpu/ops/equalize.py) is
// XLA ops, and so was the port's until these kernels (ops/equalize.py: a
// uint8 to int64 index copy, scatter_add_ over it, ~20 small ops for the
// tables, torch.gather over the index again), which moved ~26 B a pixel and
// did one global atomic a pixel. The torch route stays the plain version for
// CPU tensors, and what these kernels are held against.
//
//   K8 equalize_histogram_kernel: (N, H, W) uint8 -> (N, 256) int32 counts.
//   K9 equalize_lut_kernel: (N, 256) int32 counts -> (N, 256) uint8 tables,
//      equalize_lut's integer arithmetic: exclusive prefix sums, the last
//      populated bin, step = (npix - its count) // 255, each entry
//      (step // 2 + prefix) // step clamped at 255, and the identity where
//      at most one bin is populated or step <= 0.
//   K10 equalize_apply_kernel: out[n, p] = table[n][in[n, p]].
//
// What bounds them on an H100: device memory. K8 reads each pixel once
// (1 B a pixel, and 1 KB of counts a plane out); K10 reads and writes each
// pixel once (2 B a pixel, and the 256-B table a plane in); K9 moves 1.25 KB
// a plane. Over the 5000-image 320x240 RGB stream (1.152 GB) that is 0.344,
// 0.688 and 0.006 ms at the data sheet's 3.35 TB/s; the stream is 23x the
// 50 MB L2, so K10 reads it cold after K8.
//
// What the designs do about it:
// - K8 counts into 32 copies of the 256 bins in shared memory (32 KB), one
//   copy a lane of the warp, interleaved: bin v of lane l is word v * 32 + l.
//   So the 32 lanes of a shared-memory atomic always hit 32 distinct banks,
//   whatever the pixels: the smooth, low-noise planes a photo gives, where
//   neighbouring lanes hold the same value, cost no serialization (with one
//   copy a warp they would, up to 32-way on a flat plane). Copies of other
//   warps share a lane's words, which costs nothing: the atomics of two
//   instructions are serialized anyway. Each thread reads 16-byte vectors,
//   two in flight, coalesced over the flattened plane, and does four
//   shift-mask-atomic triples a word; at the end each thread sums one bin's
//   32 copies, rotated so the lanes of a warp read 32 banks. Where a block
//   owns its plane (the grid has enough planes to fill the card) it writes
//   its 256 counts straight out: no memset, no global atomic. Where planes
//   are few and large (4000x2250 frames), several blocks cut a plane into
//   ranges of whole vectors and add their nonzero counts into a histogram
//   zeroed on the stream first. Counts are exact whatever order the atomics
//   take.
// - K9: a warp a plane, 8 bins a lane; the prefix sums by a warp shuffle
//   scan, the last populated bin and the populated count by warp
//   reductions, 64-bit sums and quotients throughout; 8 table bytes a lane,
//   one 8-byte store.
// - K10 stages its plane's table in shared memory as 32 copies, interleaved
//   as K8's counts are (entries 4k..4k+3 of lane l in word k * 32 + l), so a
//   warp's 32 byte lookups hit 32 distinct banks. Each thread reads a
//   16-byte vector, looks up its 16 bytes and writes a 16-byte vector, two
//   vectors in flight. A vector is read before it is written by the same
//   thread, so out may be in itself.
//
// Both K8 and K10 take any plane size and any base: a plane's bytes before
// its first 16-byte boundary (head) and after its last (tail) go a byte a
// thread, by the plane's first block; where K10's input and output lie at
// different offsets from a 16-byte boundary, the whole plane goes a byte a
// thread. The pointer and the size decide this, not a flag.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kBins = 256;
constexpr long long kVec = 16;
constexpr unsigned kAll = 0xFFFFFFFFu;
static_assert(kThreads == kBins, "K8 sums a bin a thread; K10 stages a table entry a thread");
// The grid aims at this many blocks an SM before it cuts planes, and gives a
// cut at least this many vectors a thread (32 KB a block), so that a block's
// zeroing and summing of its copies stay small beside its counting.
constexpr long long kBlocksPerSm = 4;
constexpr long long kMinVectorsPerThread = 8;

// The bytes of a plane at `addr` that come before its first 16-byte boundary,
// and the whole 16-byte vectors after them.
struct Cut {
  long long head;
  long long nvec;
};

__host__ __device__ inline Cut cut_plane(uintptr_t addr, long long plane_bytes) {
  long long head = static_cast<long long>((kVec - addr % kVec) % kVec);
  if (head > plane_bytes) head = plane_bytes;
  return {head, (plane_bytes - head) / kVec};
}

// Part `part` of `parts` of a plane's vectors: [*v0, *v1).
__device__ inline void part_range(long long nvec, int part, int parts, long long* v0,
                                  long long* v1) {
  *v0 = nvec * part / parts;
  *v1 = nvec * (part + 1) / parts;
}

// ---- K8 ----

// Count the four bytes of `w` in this lane's copy: bin v at mine[v * 32].
__device__ __forceinline__ void count_word(uint32_t* mine, uint32_t w) {
  atomicAdd(mine + ((w << 5) & 0x1FE0u), 1u);
  atomicAdd(mine + ((w >> 3) & 0x1FE0u), 1u);
  atomicAdd(mine + ((w >> 11) & 0x1FE0u), 1u);
  atomicAdd(mine + ((w >> 19) & 0x1FE0u), 1u);
}

__device__ __forceinline__ void count_vec(uint32_t* mine, uint4 q) {
  count_word(mine, q.x);
  count_word(mine, q.y);
  count_word(mine, q.z);
  count_word(mine, q.w);
}

__global__ void __launch_bounds__(kThreads)
equalize_histogram_kernel(const uint8_t* __restrict__ in, int32_t* __restrict__ hist,
                          long long plane_bytes, int parts) {
  __shared__ __align__(16) uint32_t counts[kBins * kWarp];
  const int t = threadIdx.x;
  const long long plane = blockIdx.x / parts;
  const int part = static_cast<int>(blockIdx.x % parts);
  uint4* zero = reinterpret_cast<uint4*>(counts);
  for (int i = t; i < kBins * kWarp / 4; i += kThreads) zero[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  uint32_t* mine = counts + (t & (kWarp - 1));
  const uint8_t* src = in + plane * plane_bytes;
  const Cut c = cut_plane(reinterpret_cast<uintptr_t>(src), plane_bytes);
  long long v0, v1;
  part_range(c.nvec, part, parts, &v0, &v1);
  const uint4* body = reinterpret_cast<const uint4*>(src + c.head);
  long long i = v0 + t;
  for (; i + kThreads < v1; i += 2 * kThreads) {
    const uint4 a = __ldg(body + i);
    const uint4 b = __ldg(body + i + kThreads);
    count_vec(mine, a);
    count_vec(mine, b);
  }
  if (i < v1) count_vec(mine, __ldg(body + i));
  if (part == 0) {
    const long long tail = c.head + c.nvec * kVec;
    if (t < c.head) atomicAdd(mine + (static_cast<uint32_t>(src[t]) << 5), 1u);
    if (tail + t < plane_bytes) atomicAdd(mine + (static_cast<uint32_t>(src[tail + t]) << 5), 1u);
  }
  __syncthreads();

  // Bin t over the 32 copies; lane l starts at copy l, so a warp reads 32 banks.
  uint32_t sum = 0;
#pragma unroll
  for (int j = 0; j < kWarp; ++j) sum += counts[t * kWarp + ((j + t) & (kWarp - 1))];
  int32_t* dst = hist + plane * kBins + t;
  if (parts == 1) {
    *dst = static_cast<int32_t>(sum);
  } else if (sum != 0) {
    atomicAdd(dst, static_cast<int32_t>(sum));
  }
}

// ---- K9 ----

__global__ void __launch_bounds__(kThreads)
equalize_lut_kernel(const int32_t* __restrict__ hist, uint8_t* __restrict__ lut, long long n,
                    long long npix) {
  const long long plane = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  if (plane >= n) return;  // a whole warp: n planes are n whole warps
  const int lane = threadIdx.x & (kWarp - 1);
  const int4* row = reinterpret_cast<const int4*>(hist + plane * kBins + lane * 8);
  const int4 a = row[0];
  const int4 b = row[1];
  const long long h[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  long long local = 0, last_count = 0;
  int last = -1, populated = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    local += h[k];
    if (h[k] > 0) {
      last = lane * 8 + k;
      last_count = h[k];
      ++populated;
    }
  }
  long long incl = local;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const long long up = __shfl_up_sync(kAll, incl, d);
    if (lane >= d) incl += up;
  }
  const int last_bin = __reduce_max_sync(kAll, last);
  populated = __reduce_add_sync(kAll, populated);
  // The last populated bin's count, from the lane that holds it.
  last_count = __shfl_sync(kAll, last_count, last_bin < 0 ? 0 : last_bin >> 3);
  const long long step = last_bin < 0 ? 0 : (npix - last_count) / 255;
  const bool ident = populated <= 1 || step <= 0;
  long long run = incl - local;  // the exclusive prefix sum at this lane's first bin
  uint32_t word[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    long long v = lane * 8 + k;
    if (!ident) {
      v = (step / 2 + run) / step;
      v = v > 255 ? 255 : v;
    }
    word[k >> 2] |= static_cast<uint32_t>(v) << (8 * (k & 3));
    run += h[k];
  }
  *reinterpret_cast<uint2*>(lut + plane * kBins + lane * 8) = make_uint2(word[0], word[1]);
}

// ---- K10 ----

// Entry v of this lane's copy of the table: byte (v & 3) of word (v >> 2) * 32.
__device__ __forceinline__ uint32_t look(const uint8_t* mine, uint32_t v) {
  return mine[((v << 5) & 0x1F80u) | (v & 3u)];
}

__device__ __forceinline__ uint32_t map_word(const uint8_t* mine, uint32_t w) {
  return look(mine, w & 0xFFu) | (look(mine, (w >> 8) & 0xFFu) << 8) |
         (look(mine, (w >> 16) & 0xFFu) << 16) | (look(mine, w >> 24) << 24);
}

__device__ __forceinline__ uint4 map_vec(const uint8_t* mine, uint4 q) {
  return make_uint4(map_word(mine, q.x), map_word(mine, q.y), map_word(mine, q.z),
                    map_word(mine, q.w));
}

__global__ void __launch_bounds__(kThreads)
equalize_apply_kernel(const uint8_t* in, const uint8_t* __restrict__ lut, uint8_t* out,
                      long long plane_bytes, int parts) {
  __shared__ __align__(16) uint32_t table[kBins / 4 * kWarp];
  __shared__ __align__(16) uint8_t row[kBins];
  const int t = threadIdx.x;
  const long long plane = blockIdx.x / parts;
  const int part = static_cast<int>(blockIdx.x % parts);
  row[t] = lut[plane * kBins + t];
  __syncthreads();
  for (int i = t; i < kBins / 4 * kWarp; i += kThreads) {
    table[i] = reinterpret_cast<const uint32_t*>(row)[i / kWarp];
  }
  __syncthreads();

  const uint8_t* mine = reinterpret_cast<const uint8_t*>(table) + 4 * (t & (kWarp - 1));
  const uint8_t* src = in + plane * plane_bytes;
  uint8_t* dst = out + plane * plane_bytes;
  if ((reinterpret_cast<uintptr_t>(src) ^ reinterpret_cast<uintptr_t>(dst)) % kVec != 0) {
    // Input and output at different offsets from a 16-byte boundary: bytes.
    const long long b0 = plane_bytes * part / parts, b1 = plane_bytes * (part + 1) / parts;
    for (long long j = b0 + t; j < b1; j += kThreads) dst[j] = look(mine, src[j]);
    return;
  }
  const Cut c = cut_plane(reinterpret_cast<uintptr_t>(src), plane_bytes);
  long long v0, v1;
  part_range(c.nvec, part, parts, &v0, &v1);
  const uint4* body = reinterpret_cast<const uint4*>(src + c.head);
  uint4* body_out = reinterpret_cast<uint4*>(dst + c.head);
  long long i = v0 + t;
  for (; i + kThreads < v1; i += 2 * kThreads) {
    const uint4 a = body[i];
    const uint4 b = body[i + kThreads];
    body_out[i] = map_vec(mine, a);
    body_out[i + kThreads] = map_vec(mine, b);
  }
  if (i < v1) body_out[i] = map_vec(mine, body[i]);
  if (part == 0) {
    const long long tail = c.head + c.nvec * kVec;
    if (t < c.head) dst[t] = look(mine, src[t]);
    if (tail + t < plane_bytes) dst[tail + t] = look(mine, src[tail + t]);
  }
}

// ---- launches ----

// Blocks a plane: 1 where the planes alone fill the card, else enough to
// fill it, each with at least kMinVectorsPerThread vectors a thread.
int parts_for(long long n, long long plane_bytes) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();
    sms = 1;
  }
  const long long want = kBlocksPerSm * sms;
  if (n >= want) return 1;
  long long parts = (want + n - 1) / n;
  const long long most = plane_bytes / kVec / (kThreads * kMinVectorsPerThread);
  if (parts > most) parts = most;
  return parts < 1 ? 1 : static_cast<int>(parts);
}

bool plane_ok(long long n, long long plane_bytes, int parts) {
  return n >= 1 && plane_bytes >= 1 && plane_bytes <= INT_MAX && n * parts <= INT_MAX;
}

}  // namespace

// The 256-bin histogram of each of n planes of plane_bytes uint8 at `in`,
// into `hist` ((n, 256) int32, 16-byte aligned). Launches on `stream` (after
// zeroing `hist` there where planes are cut), does not synchronize and
// allocates nothing. Returns the cudaError_t of the launch as an int.
extern "C" int hipe_equalize_histogram_u8(const void* in, void* hist, long long n,
                                          long long plane_bytes, void* stream) {
  const int parts = plane_bytes >= 1 ? parts_for(n, plane_bytes) : 1;
  if (!plane_ok(n, plane_bytes, parts)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (parts > 1) {
    const cudaError_t e = cudaMemsetAsync(hist, 0, n * kBins * sizeof(int32_t), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  equalize_histogram_kernel<<<static_cast<unsigned>(n * parts), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(in), static_cast<int32_t*>(hist), plane_bytes, parts);
  return static_cast<int>(cudaGetLastError());
}

// Equalize's table of each of n histograms ((n, 256) int32, 16-byte
// aligned) of planes of npix pixels, into `lut` ((n, 256) uint8, 8-byte
// aligned). Launches on `stream`, as above.
extern "C" int hipe_equalize_lut_u8(const void* hist, void* lut, long long n, long long npix,
                                    void* stream) {
  constexpr long long kPlanesPerBlock = kThreads / kWarp;
  const long long blocks = (n + kPlanesPerBlock - 1) / kPlanesPerBlock;
  if (n < 1 || npix < 0 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  equalize_lut_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hist), static_cast<uint8_t*>(lut), n, npix);
  return static_cast<int>(cudaGetLastError());
}

// out[p, j] = lut[p, in[p, j]] for n planes of plane_bytes uint8; `out` may
// be `in`, and must not overlap it otherwise. Launches on `stream`, as above.
extern "C" int hipe_equalize_apply_u8(const void* in, const void* lut, void* out, long long n,
                                      long long plane_bytes, void* stream) {
  const int parts = plane_bytes >= 1 ? parts_for(n, plane_bytes) : 1;
  if (!plane_ok(n, plane_bytes, parts)) return static_cast<int>(cudaErrorInvalidValue);
  equalize_apply_kernel<<<static_cast<unsigned>(n * parts), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<const uint8_t*>(lut),
      static_cast<uint8_t*>(out), plane_bytes, parts);
  return static_cast<int>(cudaGetLastError());
}
