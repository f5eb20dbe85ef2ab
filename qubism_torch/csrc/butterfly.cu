// K6: a dense S x S complex gate across S = 2^k <= 16 whole banks, in place:
// y_i = sum_j U[i, j] x_j, where x_j is bank j (2^m amplitudes each).
//
// Replaces: qubism_tpu/ops/kernels.py::_shard_butterfly_fn (entry
// shard_butterfly_prepare), which streamed (BR, C) tiles of every bank
// through VMEM with all 2S planes aliased in place and U in SMEM. The mesh
// path (parallel/sharded.py) runs it for every dense op whose targets are all
// bank bits; each bank is its own buffer, so the gate is not a K1 pass.
//
// Bound: device memory. A position (one offset in every bank) costs S reads,
// S writes and S^2 complex MACs: 8 S^2 flop over 16 S bytes, S/2 flop per
// byte, 8 at S = 16, under the card's ~20 flop/B balance point.
// Design: one thread per float4 (two neighbouring amplitudes) of a bank: it
// loads that float4 from each of the S banks into registers, forms the S
// outputs and writes them back to the same addresses. Every read of a
// position comes before any write to it and no two threads share a
// position, so the update in place is safe. Warps read and write contiguous
// 512-byte runs of each bank. The S bank pointers and U sit in the kernel
// parameters (2176 bytes at S = 16) and are read only at indices fixed at
// compile time: the kernel is templated on S and fully unrolled, so they
// stay in the constant bank (a run-time index into the parameter block
// copies it to local memory, as gate.cu notes).
#include "common.cuh"

namespace {

template <int S>
struct ButterflyArgs {
  float4* bank[S];  // bank j: 2^m amplitudes as 2^(m-1) float4
  float2 u[S * S];  // U, row-major
};

template <int S>
__global__ void __launch_bounds__(qk::kThreads)
butterfly_kernel(int64_t quads, const ButterflyArgs<S> a) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t p = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; p < quads; p += stride) {
    float4 x[S];
#pragma unroll
    for (int j = 0; j < S; ++j) x[j] = a.bank[j][p];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float2 lo = make_float2(0.f, 0.f), hi = make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        lo = qk::cfma(a.u[i * S + j], make_float2(x[j].x, x[j].y), lo);
        hi = qk::cfma(a.u[i * S + j], make_float2(x[j].z, x[j].w), hi);
      }
      a.bank[i][p] = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }
}

template <int S>
int launch_butterfly(void* const* banks, int64_t m, const float2* u, cudaStream_t stream) {
  ButterflyArgs<S> a;
  for (int j = 0; j < S; ++j) a.bank[j] = static_cast<float4*>(banks[j]);
  for (int t = 0; t < S * S; ++t) a.u[t] = u[t];
  const int64_t quads = int64_t(1) << (m - 1);
  butterfly_kernel<S><<<qk::grid_for(quads, qk::kThreads), qk::kThreads, 0, stream>>>(quads, a);
  return (int)cudaGetLastError();
}

}  // namespace

// banks: host array of S device pointers, each to 2^m complex64 amplitudes,
// 16-byte aligned and not overlapping; m >= 1; u: host float2[S * S].
extern "C" int qk_butterfly(const void* banks, int s, int64_t m, const void* u,
                            int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (m < 1) return (int)cudaErrorInvalidValue;
  void* const* b = static_cast<void* const*>(banks);
  const float2* c = static_cast<const float2*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 2: return launch_butterfly<2>(b, m, c, st);
    case 4: return launch_butterfly<4>(b, m, c, st);
    case 8: return launch_butterfly<8>(b, m, c, st);
    case 16: return launch_butterfly<16>(b, m, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
