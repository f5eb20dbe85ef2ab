// Shared helpers of the state-vector kernels (qubism_torch/csrc/*.cu).
//
// A state is 2^n complex64 amplitudes read and written as float2, in the
// big-endian qubit order of the JAX package: qubit q is bit n-1-q of the
// index. Every index is 64-bit (2^n overflows int32 from n = 31). Each
// kernel updates the state in place, and no thread writes an element that
// another thread reads.
//
// Every C entry point sets the device, launches on the caller's stream
// (torch.cuda.current_stream()), does not synchronise, and returns
// cudaGetLastError() so that a refused launch is reported.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qk {

constexpr int kThreads = 256;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * b + c, in full fp32 FMAs
__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 c) {
  return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, c.x)),
                     fmaf(a.x, b.y, fmaf(a.y, b.x, c.y)));
}

// Spread a group number over the index space: insert a zero bit at each
// position of pos_asc (ascending), giving the group's base index.
template <int K>
__device__ __forceinline__ int64_t insert_zero_bits(int64_t g, const int* pos_asc) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int p = pos_asc[j];
    g = ((g >> p) << (p + 1)) | (g & ((int64_t(1) << p) - 1));
  }
  return g;
}

// Blocks for a grid-stride loop over `work` items (enough to fill the card).
inline unsigned int grid_for(int64_t work, int threads) {
  int64_t b = (work + threads - 1) / threads;
  const int64_t cap = int64_t(1) << 16;
  if (b > cap) b = cap;
  if (b < 1) b = 1;
  return (unsigned int)b;
}

// Sort k (<= 8) bit positions ascending, host side.
inline void sort_positions(const int64_t* pos, int k, int* out) {
  for (int i = 0; i < k; ++i) out[i] = (int)pos[i];
  for (int i = 1; i < k; ++i)
    for (int j = i; j > 0 && out[j - 1] > out[j]; --j) {
      const int t = out[j];
      out[j] = out[j - 1];
      out[j - 1] = t;
    }
}

}  // namespace qk
