// The sums of a pair of states under sign masks, in one pass.
//
// Replaces: the chunk loop of qubism_torch/ops/measure.py::pauli_pair_sums
// on a CUDA device (the JAX package's pair reductions,
// qubism_tpu/ops/measure.py, are plain XLA). For each sign mask z_j it adds
//   sum_x conj(b[x ^ f]) (-1)^popcount(x & z_j) a[x]
// as float64 (re, im) into out[j]: the product of a pair in float32, as the
// plain version makes it, and every sum after it in float64.
//
// Bound: device memory at few masks (a and b read once each), the float64
// adds at many (k adds of two doubles per amplitude).
// Design: a block takes tiles of kTile amplitudes, grid-stride. Its threads
// load a tile's products into shared memory; then the block is G = 256 / k
// groups of k threads, and thread (g, j) adds, for mask j, the tile's
// entries g, g + G, g + 2G, ... into two float64 registers that it keeps
// over the block's tiles. At the end the block sums its groups in shared
// memory and adds one pair per mask into out with atomicAdd, so the order
// of the float64 additions across blocks is not fixed. More than 256 masks
// are launched 256 at a time. The masks stay in the kernel's parameters
// (__grid_constant__, so that a thread's read of its mask at a computed
// index makes no local copy of them).
#include "common.cuh"

namespace {

constexpr int kTile = 2048;
constexpr int kMasks = qk::kThreads;

struct PairArgs {
  int64_t f;
  int k;
  int64_t z[kMasks];
};

__global__ void __launch_bounds__(qk::kThreads)
pair_kernel(const float2* __restrict__ a, const float2* __restrict__ b, int64_t size,
            double* __restrict__ out, const __grid_constant__ PairArgs args) {
  __shared__ float2 tile[kTile];
  __shared__ double part_re[qk::kThreads];
  __shared__ double part_im[qk::kThreads];
  const int t = threadIdx.x;
  const int k = args.k;
  const int groups = qk::kThreads / k;
  const int j = t % k, grp = t / k;
  const bool active = grp < groups;
  const int64_t z = args.z[j];
  double re = 0.0, im = 0.0;
  for (int64_t base = int64_t(blockIdx.x) * kTile; base < size;
       base += int64_t(gridDim.x) * kTile) {
    const int len = size - base < kTile ? int(size - base) : kTile;
    for (int e = t; e < len; e += qk::kThreads) {
      const int64_t x = base + e;
      const float2 av = a[x], bv = b[x ^ args.f];
      // conj(bv) * av, rounded as written (no fused multiply-add), so that
      // a state against itself has an imaginary part of exactly 0
      tile[e] = make_float2(__fadd_rn(__fmul_rn(bv.x, av.x), __fmul_rn(bv.y, av.y)),
                            __fsub_rn(__fmul_rn(bv.x, av.y), __fmul_rn(bv.y, av.x)));
    }
    __syncthreads();
    if (active) {
      for (int e = grp; e < len; e += groups) {
        const float2 p = tile[e];
        const bool neg = __popcll((base + e) & z) & 1;
        re += neg ? -double(p.x) : double(p.x);
        im += neg ? -double(p.y) : double(p.y);
      }
    }
    __syncthreads();
  }
  part_re[t] = re;
  part_im[t] = im;
  __syncthreads();
  if (t < k) {
    double sr = 0.0, si = 0.0;
    for (int g = 0; g < groups; ++g) {
      sr += part_re[g * k + t];
      si += part_im[g * k + t];
    }
    atomicAdd(out + 2 * t, sr);
    atomicAdd(out + 2 * t + 1, si);
  }
}

}  // namespace

// a, b: device float2[2^n] (b may be a); f: the flip mask, < 2^n; zs: host
// int64[k], the sign masks; out: device float64[k][2], added into (the
// caller zeroes it).
extern "C" int qk_pair_sums(const void* a, const void* b, int64_t n, int64_t f, int k,
                            const void* zs, void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n < 1 || n > 40 || k < 1 || f < 0 || f >= (int64_t(1) << n))
    return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pair_kernel, qk::kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const int64_t size = int64_t(1) << n;
  const int64_t tiles = (size + kTile - 1) / kTile;
  int64_t blocks = int64_t(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > tiles) blocks = tiles;
  const int64_t* z = static_cast<const int64_t*>(zs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int j0 = 0; j0 < k; j0 += kMasks) {
    PairArgs args;
    args.f = f;
    args.k = k - j0 < kMasks ? k - j0 : kMasks;
    for (int j = 0; j < kMasks; ++j) args.z[j] = j < args.k ? z[j0 + j] : 0;
    pair_kernel<<<(unsigned int)blocks, qk::kThreads, 0, st>>>(
        static_cast<const float2*>(a), static_cast<const float2*>(b), size,
        static_cast<double*>(out) + 2 * int64_t(j0), args);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
