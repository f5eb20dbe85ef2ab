// The copy and read passes of the HBM bandwidth probe, redesigned for the
// H100 (the phase and write passes stay on stream_kernel in probe.cu).
//
// Replaces two pallas_call sites of experiments/bw_probe.py:
//   qk_probe_copy  src -> dst                      make_pallas_copy (:81)
//   qk_probe_read  sum of every re and im, as one  make_pallas_read_only (:189)
//                  float (added in double)
//
// Bound: device memory. The copy reads and writes 16 B per amplitude, the
// read reads 8 B and adds 2 floats; far below the card's balance point.
//
// Tiles: the state is cut into tiles of T * VEC float4s (T threads a
// block, VEC 16-byte accesses a thread and step; access j of thread t in a
// tile is float4 j * T + t, so each warp's access is one contiguous
// 512-byte run). The caller (ops/probes.py: partition) gives the grid:
// `blocks` blocks, block b taking per + (b < extra) tiles. Full tiles run
// without a predicate; the float4s past the last full tile (only when the
// state is smaller than a tile, or T is not a power of two) are the last
// block's, predicated. Loads are streaming (__ldcs: evict-first, the state
// is not read again), the copy's stores too (__stcs); the input is
// __restrict__, so a step's VEC loads all start before its stores.
//
// The copy takes one block a tile (the caller caps the grid at 2^30 blocks;
// past that block b takes the tiles b, b + G, b + 2G, ...). A grid of
// persistent blocks, each walking its own share, read 3-5% slower than
// copy_ on the H100 (PERF.md, Findings): a copy mixes reads and writes, and
// HBM serves it best when the tiles in flight form one window that moves
// forward, which the in-order dispatch of short blocks keeps and
// persistent blocks drifting apart lose. It also caps the blocks an SM
// holds (padding their dynamic shared memory) so that at most the caller's
// inflight_kib of tiles are in flight an SM: the copy read fastest with
// 32-64 KiB an SM, slower with 128 (more requests queued against the same
// rows), and far slower under 24. A design that moved the tiles with TMA
// bulk copies through shared memory read 0.2-0.6% slower and was dropped.
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

// Block b copies the tiles b, b + G, b + 2G, ... (G blocks), per + (b <
// extra) of them.
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
copy_kernel(const float4* __restrict__ src, float4* __restrict__ dst, int64_t items, int64_t per,
            int extra) {
  const int T = blockDim.x;
  const int64_t tile = int64_t(T) * VEC, stride = tile * gridDim.x;
  const int64_t count = per + (int(blockIdx.x) < extra ? 1 : 0);
  const float4* s = src + blockIdx.x * tile + threadIdx.x;
  float4* d = dst + blockIdx.x * tile + threadIdx.x;
  for (int64_t k = 0; k < count; ++k, s += stride, d += stride) {
    float4 x[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) x[j] = __ldcs(s + j * T);
#pragma unroll
    for (int j = 0; j < VEC; ++j) __stcs(d + j * T, x[j]);
  }
  if (blockIdx.x == gridDim.x - 1)  // the float4s past the last full tile
    for (int64_t i = (items / tile) * tile + threadIdx.x; i < items; i += T)
      __stcs(dst + i, __ldcs(src + i));
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

// The partition the caller computed: `blocks` blocks, per + (b < extra)
// tiles each, covering every full tile.
bool partition_ok(int64_t items, int threads, int vec, int blocks, int64_t per, int extra) {
  const int64_t tiles = items / (int64_t(threads) * vec);
  return blocks >= 1 && per >= 0 && extra >= 0 && extra < blocks &&
         int64_t(blocks) * per + extra == tiles;
}

const void* copy_fn(int vec) {
  return vec == 1   ? reinterpret_cast<const void*>(copy_kernel<1>)
         : vec == 2 ? reinterpret_cast<const void*>(copy_kernel<2>)
                    : reinterpret_cast<const void*>(copy_kernel<4>);
}

// The copy launch's dynamic shared memory: none, or enough that at most
// inflight_kib of tiles are resident on an SM (at least one block).
// inflight_kib 0: no cap.
cudaError_t copy_smem(int threads, int vec, int inflight_kib, int device, int* smem) {
  const void* fn = copy_fn(vec);
  *smem = 0;
  int resident;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, threads, 0);
  const int64_t tile_bytes = int64_t(threads) * vec * 16;
  const int cap = int(std::max<int64_t>(1, int64_t(inflight_kib) * 1024 / tile_bytes));
  if (e != cudaSuccess || inflight_kib <= 0 || resident <= cap) return e;
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

const void* read_fn(int vec) {
  return vec == 1   ? reinterpret_cast<const void*>(read_kernel<1>)
         : vec == 2 ? reinterpret_cast<const void*>(read_kernel<2>)
                    : reinterpret_cast<const void*>(read_kernel<4>);
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
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], read_fn(vec), threads, 0);
}

// src, dst: device float2[2^n], two buffers; threads, vec: the tile
// (threads x vec float4s); blocks, per, extra: the partition; inflight_kib:
// the most KiB of tiles resident on an SM (0: no cap).
extern "C" int qk_probe_copy(const void* src, void* dst, int64_t n, int threads, int vec,
                             int blocks, int64_t per, int extra, int inflight_kib, int device,
                             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int64_t items = (int64_t(1) << n) / 2;  // float4s
  if (n < 1 || n > 40 || !src || !dst || src == dst || !geometry_ok(threads, vec) ||
      inflight_kib < 0 || !partition_ok(items, threads, vec, blocks, per, extra))
    return (int)cudaErrorInvalidValue;
  int smem;
  e = copy_smem(threads, vec, inflight_kib, device, &smem);
  if (e != cudaSuccess) return (int)e;
  const float4* s = static_cast<const float4*>(src);
  float4* d = static_cast<float4*>(dst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 1: copy_kernel<1><<<blocks, threads, smem, st>>>(s, d, items, per, extra); break;
    case 2: copy_kernel<2><<<blocks, threads, smem, st>>>(s, d, items, per, extra); break;
    default: copy_kernel<4><<<blocks, threads, smem, st>>>(s, d, items, per, extra);
  }
  return (int)cudaGetLastError();
}

// src: device float2[2^n]; partial: device float[partial_len >= blocks] and
// counter: device uint32[1] = 0, the caller's scratch (the counter is 0
// again when the kernel ends); out: device float[1], the sum.
extern "C" int qk_probe_read(const void* src, int64_t n, int threads, int vec, int blocks,
                             int64_t per, int extra, void* partial, int64_t partial_len,
                             void* counter, void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int64_t items = (int64_t(1) << n) / 2;
  if (n < 1 || n > 40 || !src || !partial || !counter || !out || !geometry_ok(threads, vec) ||
      partial_len < blocks || !partition_ok(items, threads, vec, blocks, per, extra))
    return (int)cudaErrorInvalidValue;
  const float4* s = static_cast<const float4*>(src);
  float* p = static_cast<float*>(partial);
  unsigned int* c = static_cast<unsigned int*>(counter);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 1: read_kernel<1><<<blocks, threads, 0, st>>>(s, items, per, extra, p, c, o); break;
    case 2: read_kernel<2><<<blocks, threads, 0, st>>>(s, items, per, extra, p, c, o); break;
    default: read_kernel<4><<<blocks, threads, 0, st>>>(s, items, per, extra, p, c, o);
  }
  return (int)cudaGetLastError();
}
