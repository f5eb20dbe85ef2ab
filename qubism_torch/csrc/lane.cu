// K3: a dense gate on the lowest min(n, 7) qubits, expanded to an L x L
// complex matrix U (L = 2^min(n,7)): out[r, :] = x[r, :] . U^T for every
// row r of L consecutive amplitudes.
//
// Replaces: qubism_tpu/ops/kernels.py::_lane_gate_fn (entries
// lane_gate_prepare / lane_gate), which ran the product as four real
// 128-wide matmuls on the MXU at Precision.HIGHEST.
//
// Bound: compute. L = 128 complex MACs per amplitude is 1024 flop per
// 16 B read and written (64 flop/B), above the card's fp32 balance point,
// so this is the slowest pass of the file path. It uses full fp32 FMAs
// only (TF32 on the tensor cores would drift ~1e-4 from the reference).
// Design: U^T (128 KB at L = 128) is staged once per block in dynamic
// shared memory. A block of 512 threads walks tiles of 4096 amplitudes:
// it loads the tile into shared memory before writing anything (the update
// is in place), then each thread forms one output column j for 8 rows,
// reading U^T[i][j] (consecutive j across a warp: conflict-free) and the
// rows' x[i] (one address per warp: a broadcast), and writes its 8
// results. 160 KB of shared memory leaves one block per SM.
#include "common.cuh"

namespace {

constexpr int kLaneThreads = 512;
constexpr int kTile = 4096;         // amplitudes per tile
constexpr int kRowsPerThread = 8;   // = kTile / kLaneThreads

__global__ void __launch_bounds__(kLaneThreads)
lane_kernel(float2* __restrict__ s, int64_t rows, int L, const float2* __restrict__ ut) {
  extern __shared__ float2 smem[];
  float2* u = smem;           // u[i * L + j] = U[j][i]
  float2* xt = smem + L * L;  // the tile, row-major
  const int j = threadIdx.x % L;
  const int slot = threadIdx.x / L;
  const int tile_rows = kTile / L;
  for (int t = threadIdx.x; t < L * L; t += blockDim.x) u[t] = ut[t];
  for (int64_t r0 = int64_t(blockIdx.x) * tile_rows; r0 < rows;
       r0 += int64_t(gridDim.x) * tile_rows) {
    const int nr = rows - r0 < tile_rows ? int(rows - r0) : tile_rows;
    __syncthreads();  // U is staged and the previous tile is consumed
    const float2* src = s + r0 * L;
    for (int t = threadIdx.x; t < nr * L; t += blockDim.x) xt[t] = src[t];
    __syncthreads();
    float2 acc[kRowsPerThread];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) acc[q] = make_float2(0.f, 0.f);
    const float2* xr = xt + slot * kRowsPerThread * L;
    for (int i = 0; i < L; ++i) {
      const float2 uv = u[i * L + j];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) acc[q] = qk::cfma(uv, xr[q * L + i], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int row = slot * kRowsPerThread + q;
      if (row < nr) s[(r0 + row) * L + j] = acc[q];
    }
  }
}

}  // namespace

// state: device float2[2^n]; ut: device float2[L][L] holding U transposed.
extern "C" int qk_lane(void* state, int64_t n, const void* ut, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int L = 1 << (n < 7 ? n : 7);
  const size_t smem = (size_t(L) * L + kTile) * sizeof(float2);
  e = cudaFuncSetAttribute(lane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int64_t rows = (int64_t(1) << n) / L;
  const int64_t tiles = (rows + kTile / L - 1) / (kTile / L);
  const unsigned int blocks = (unsigned int)(tiles < sms ? tiles : sms);
  lane_kernel<<<blocks, kLaneThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(state), rows, L, static_cast<const float2*>(ut));
  return (int)cudaGetLastError();
}
