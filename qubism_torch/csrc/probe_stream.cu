// The stream passes of the HBM bandwidth probe (copy, phase, read, write),
// redesigned for the H100 (the pair probe is csrc/probe.cu).
//
// Replaces six pallas_call sites of experiments/bw_probe.py:
//   qk_probe_copy   src -> dst                     make_pallas_copy (:81)
//   qk_probe_phase  x * (c1 + i c2), in place      make_pallas_phase (:50),
//                                                  phase2d in main_canon (:573)
//                   or into a second buffer        make_pallas_phase_noalias (:157)
//   qk_probe_read   sum of every re and im, as one make_pallas_read_only (:189)
//                   float (added in double)
//   qk_probe_write  re = v, im = v / 2, v = *seed  make_pallas_write_only (:220)
//
// Bound: device memory. Copy and phase read and write 16 B per amplitude
// (the phase adds 6 flop), the read reads 8 B and adds 2 floats, the write
// writes 8 B; far below the card's balance point.
//
// Tiles: the state is cut into tiles of T * VEC float4s (T threads a
// block, VEC 16-byte accesses a thread and step; access j of thread t in a
// tile is float4 j * T + t, so each warp's access is one contiguous
// 512-byte run). The caller (ops/probes.py: partition) gives the grid:
// `blocks` blocks, block b taking per + (b < extra) tiles. Full tiles run
// without a predicate; the float4s past the last full tile (only when the
// state is smaller than a tile, or T is not a power of two) are the last
// block's, predicated. Loads and stores are streaming (__ldcs, __stcs:
// evict-first, the state is not read again).
//
// Copy, phase and write share one body (tile_pass): one block a tile (the
// caller caps the grid at 2^30 blocks; past that block b takes the tiles
// b, b + G, b + 2G, ...). A grid of persistent blocks, each walking its own
// share, read 3-5% slower than copy_ on the H100 (PERF.md, Findings): a
// pass that writes is served best when the tiles in flight form one
// window that moves forward, which the in-order dispatch of short blocks
// keeps and persistent blocks drifting apart lose. The launch also caps
// the blocks an SM holds (padding their dynamic shared memory) so that at
// most the caller's inflight_kib of tiles are in flight an SM: the copy
// read fastest with 32-64 KiB an SM, slower with 128 (more requests queued
// against the same rows), and far slower under 24. A design that moved the
// tiles with TMA bulk copies through shared memory read 0.2-0.6% slower
// and was dropped. Into a second buffer the two pointers are __restrict__,
// so a step's VEC loads all start before its stores; in place the kernel
// takes one pointer, loads a step's VEC float4s and then stores them. The
// write stores alone (with __stcs and the cap: a plain st.global.v4, no
// cap, and a TMA bulk store of one constant tile from shared memory read
// level or up to 0.2% slower), a value it builds from a one-element seed
// buffer that the caller copied out of the state first, so that no block
// reads the state while others write it.
//
// The read keeps persistent blocks, as many as fit on the card at once
// (qk_probe_read_occupancy), each adding a contiguous run of tiles, and
// runs in one launch: each thread keeps VEC float accumulators (one per
// load in flight, so additions do not wait on each other), adds them in a
// fixed order, the block adds its threads in a fixed tree and writes one
// partial; the block that takes the last ticket of a device counter adds
// the partials in double, in block order, and resets the counter. So the
// sum is the same bit for bit from call to call. The partials and the
// counter are scratch that the caller keeps per device: two reads in
// flight at once on two streams would share it, so reads run on one
// stream at a time.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
// the most shared memory a block may take
constexpr int kMaxSmem = 227 * 1024;

enum Op { kCopy, kPhase, kWrite };

// The sum of v over the block, valid in thread 0: a shuffle tree in each
// warp, then the same tree over the warps' sums. Uses 32 words of shared
// memory; blockDim.x is a multiple of 32.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < int(blockDim.x / 32) ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// What copy and phase store for the float4 x (two amplitudes) they loaded.
template <int OP>
__device__ __forceinline__ float4 apply(float4 x, float2 c) {
  if (OP == kCopy) return x;
  return make_float4(x.x * c.x - x.y * c.y, x.x * c.y + x.y * c.x, x.z * c.x - x.w * c.y,
                     x.z * c.y + x.w * c.x);
}

// The body of copy, phase and write: block b of G takes the tiles b, b + G,
// b + 2G, ..., per + (b < extra) of them, and the last block the float4s
// past the last full tile. dst[i] = apply(src[i]), or w (write: src unused).
template <int OP, int VEC>
__device__ __forceinline__ void tile_pass(const float4* src, float4* dst, int64_t items,
                                          int64_t per, int extra, float2 c, float4 w) {
  const int T = blockDim.x;
  const int64_t tile = int64_t(T) * VEC, stride = tile * gridDim.x;
  const int64_t count = per + (int(blockIdx.x) < extra ? 1 : 0);
  const int64_t first = blockIdx.x * tile + threadIdx.x;
  for (int64_t k = 0, i = first; k < count; ++k, i += stride) {
    if (OP == kWrite) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) __stcs(dst + i + j * T, w);
      continue;
    }
    float4 x[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) x[j] = __ldcs(src + i + j * T);
#pragma unroll
    for (int j = 0; j < VEC; ++j) __stcs(dst + i + j * T, apply<OP>(x[j], c));
  }
  if (blockIdx.x == gridDim.x - 1)
    for (int64_t i = (items / tile) * tile + threadIdx.x; i < items; i += T)
      __stcs(dst + i, OP == kWrite ? w : apply<OP>(__ldcs(src + i), c));
}

// copy (kCopy) and phase (kPhase) into a second buffer
template <int OP, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
tile_kernel(const float4* __restrict__ src, float4* __restrict__ dst, int64_t items, int64_t per,
            int extra, float2 c) {
  tile_pass<OP, VEC>(src, dst, items, per, extra, c, float4{});
}

// the phase in place: one pointer
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
phase_inplace_kernel(float4* x, int64_t items, int64_t per, int extra, float2 c) {
  tile_pass<kPhase, VEC>(x, x, items, per, extra, c, float4{});
}

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
write_kernel(float4* __restrict__ dst, int64_t items, int64_t per, int extra,
             const float* __restrict__ seed) {
  const float v = *seed;
  tile_pass<kWrite, VEC>(nullptr, dst, items, per, extra, float2{},
                         make_float4(v, 0.5f * v, v, 0.5f * v));
}

// Block b adds the tiles [b * per + min(b, extra), + per + (b < extra)).
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
read_kernel(const float4* __restrict__ src, int64_t items, int64_t per, int extra,
            float* partial, unsigned int* counter, float* out) {
  const int T = blockDim.x, b = blockIdx.x;
  const int64_t tile = int64_t(T) * VEC;
  const int64_t count = per + (b < extra ? 1 : 0);
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  const float4* s = src + (int64_t(b) * per + min(b, extra)) * tile + threadIdx.x;
  for (int64_t k = 0; k < count; ++k, s += tile) {
    float4 x[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) x[j] = __ldcs(s + j * T);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += (x[j].x + x[j].y) + (x[j].z + x[j].w);
  }
  if (b == int(gridDim.x) - 1)
    for (int64_t i = (items / tile) * tile + threadIdx.x; i < items; i += T) {
      const float4 x = __ldcs(src + i);
      acc[0] += (x.x + x.y) + (x.z + x.w);
    }
  float v = acc[0];
#pragma unroll
  for (int j = 1; j < VEC; ++j) v += acc[j];
  v = block_sum(v);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[b] = v;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
    if (last) __threadfence();  // and every other block's before the last adds them
  }
  __syncthreads();
  if (!last) return;
  double a = 0.0;
  for (int i = threadIdx.x; i < int(gridDim.x); i += T) a += double(__ldcg(partial + i));
  a = block_sum(a);
  if (threadIdx.x == 0) {
    out[0] = float(a);
    *counter = 0u;  // ready for the next read on this stream
  }
}

bool geometry_ok(int threads, int vec) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
         (vec == 1 || vec == 2 || vec == 4);
}

// n, the tile and the partition the caller computed: `blocks` blocks, per +
// (b < extra) tiles each, covering every full tile.
bool partition_ok(int64_t n, int threads, int vec, int blocks, int64_t per, int extra) {
  if (n < 1 || n > 40 || !geometry_ok(threads, vec)) return false;
  const int64_t tiles = (int64_t(1) << n) / 2 / (int64_t(threads) * vec);
  return blocks >= 1 && per >= 0 && extra >= 0 && extra < blocks &&
         int64_t(blocks) * per + extra == tiles;
}

// The kernel of a family for vec = 1, 2 or 4.
template <typename F>
F by_vec(int vec, F v1, F v2, F v4) {
  return vec == 1 ? v1 : vec == 2 ? v2 : v4;
}

// The dynamic shared memory of a launch of fn: none, or enough that at
// most inflight_kib of tiles are resident on an SM (at least one block).
// inflight_kib 0: no cap.
cudaError_t inflight_smem(const void* fn, int threads, int vec, int inflight_kib, int device,
                          int* smem) {
  *smem = 0;
  if (inflight_kib <= 0) return cudaSuccess;
  int resident;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, threads, 0);
  const int64_t tile_bytes = int64_t(threads) * vec * 16;
  const int cap = int(std::max<int64_t>(1, int64_t(inflight_kib) * 1024 / tile_bytes));
  if (e != cudaSuccess || resident <= cap) return e;
  int per_sm, reserved;
  cudaFuncAttributes attr;
  if ((e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                  device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                                  device)) != cudaSuccess ||
      (e = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess)
    return e;
  *smem = std::min(std::max((per_sm / cap - reserved - int(attr.sharedSizeBytes)) & ~127, 0),
                   kMaxSmem);
  if (*smem > 48 * 1024)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  return e;
}

template <typename T>
struct same {
  using type = T;
};

// Launch fn(a...) on `blocks` blocks of `threads`, at most inflight_kib of
// tiles resident an SM (0: no cap). Each argument is converted to its
// parameter's type before its address is taken.
template <typename... P>
int launch_tiles(void (*fn)(P...), int threads, int vec, int blocks, int inflight_kib,
                 int device, void* stream, typename same<P>::type... a) {
  const void* f = reinterpret_cast<const void*>(fn);
  int smem;
  cudaError_t e = inflight_smem(f, threads, vec, inflight_kib, device, &smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a...};
  e = cudaLaunchKernel(f, dim3(blocks), dim3(threads), args, smem,
                       static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

decltype(&read_kernel<1>) read_fn(int vec) {
  return by_vec(vec, read_kernel<1>, read_kernel<2>, read_kernel<4>);
}

}  // namespace

// out[0] = the SM count, out[1] = the read kernel's blocks of `threads`
// (vec: 1, 2 or 4) that fit on one SM.
extern "C" int qk_probe_read_occupancy(int threads, int vec, int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!geometry_ok(threads, vec) || !out) return (int)cudaErrorInvalidValue;
  e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], reinterpret_cast<const void*>(read_fn(vec)), threads, 0);
}

// src, dst: device float2[2^n], two buffers; threads, vec: the tile
// (threads x vec float4s); blocks, per, extra: the partition; inflight_kib:
// the most KiB of tiles resident on an SM (0: no cap).
extern "C" int qk_probe_copy(const void* src, void* dst, int64_t n, int threads, int vec,
                             int blocks, int64_t per, int extra, int inflight_kib, int device,
                             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!src || !dst || src == dst || inflight_kib < 0 ||
      !partition_ok(n, threads, vec, blocks, per, extra))
    return (int)cudaErrorInvalidValue;
  const int64_t items = (int64_t(1) << n) / 2;  // float4s
  return launch_tiles(by_vec(vec, tile_kernel<kCopy, 1>, tile_kernel<kCopy, 2>,
                             tile_kernel<kCopy, 4>),
                      threads, vec, blocks, inflight_kib, device, stream,
                      static_cast<const float4*>(src), static_cast<float4*>(dst), items, per,
                      extra, make_float2(1.f, 0.f));
}

// src: device float2[2^n]; dst: a second buffer of the same size, or null:
// the phase in place; c: host float2, the phase. threads, vec, blocks, per,
// extra, inflight_kib: as qk_probe_copy.
extern "C" int qk_probe_phase(void* src, void* dst, int64_t n, const void* c, int threads,
                              int vec, int blocks, int64_t per, int extra, int inflight_kib,
                              int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!src || src == dst || !c || inflight_kib < 0 ||
      !partition_ok(n, threads, vec, blocks, per, extra))
    return (int)cudaErrorInvalidValue;
  const int64_t items = (int64_t(1) << n) / 2;
  const float2 ph = *static_cast<const float2*>(c);
  float4* s = static_cast<float4*>(src);
  if (!dst)
    return launch_tiles(by_vec(vec, phase_inplace_kernel<1>, phase_inplace_kernel<2>,
                               phase_inplace_kernel<4>),
                        threads, vec, blocks, inflight_kib, device, stream, s, items, per, extra,
                        ph);
  return launch_tiles(by_vec(vec, tile_kernel<kPhase, 1>, tile_kernel<kPhase, 2>,
                             tile_kernel<kPhase, 4>),
                      threads, vec, blocks, inflight_kib, device, stream,
                      static_cast<const float4*>(s), static_cast<float4*>(dst), items, per, extra,
                      ph);
}

// dst: device float2[2^n]; seed: device float[1] holding v (the caller
// copies it out of the state first). threads, vec, blocks, per, extra,
// inflight_kib: as qk_probe_copy.
extern "C" int qk_probe_write(void* dst, int64_t n, const void* seed, int threads, int vec,
                              int blocks, int64_t per, int extra, int inflight_kib, int device,
                              void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!dst || !seed || inflight_kib < 0 || !partition_ok(n, threads, vec, blocks, per, extra))
    return (int)cudaErrorInvalidValue;
  const int64_t items = (int64_t(1) << n) / 2;
  return launch_tiles(by_vec(vec, write_kernel<1>, write_kernel<2>, write_kernel<4>), threads,
                      vec, blocks, inflight_kib, device, stream, static_cast<float4*>(dst),
                      items, per, extra, static_cast<const float*>(seed));
}

// src: device float2[2^n]; partial: device float[partial_len >= blocks] and
// counter: device uint32[1] = 0, the caller's scratch (the counter is 0
// again when the kernel ends); out: device float[1], the sum.
extern "C" int qk_probe_read(const void* src, int64_t n, int threads, int vec, int blocks,
                             int64_t per, int extra, void* partial, int64_t partial_len,
                             void* counter, void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!src || !partial || !counter || !out || partial_len < blocks ||
      !partition_ok(n, threads, vec, blocks, per, extra))
    return (int)cudaErrorInvalidValue;
  const int64_t items = (int64_t(1) << n) / 2;
  return launch_tiles(read_fn(vec), threads, vec, blocks, 0, device, stream,
                      static_cast<const float4*>(src), items, per, extra,
                      static_cast<float*>(partial), static_cast<unsigned int*>(counter),
                      static_cast<float*>(out));
}
