// K1: a dense 2^k x 2^k complex gate, 1 <= k <= 4, on any k qubits.
//
// Replaces: qubism_tpu/ops/kernels.py::_gate_fn with stage=0 (entries
// row_gate_prepare / row_gate). The TPU kernel reached each target as a
// block-slot axis or a sublane/lane roll of a (R, 2048) tile and could
// skip structural zeros through a static mask; on this card the index
// arithmetic is free, so one thread takes one group of 2^k amplitudes
// wherever its targets lie, and the zero mask is not needed (skipping
// zero terms and multiplying by them give the same result).
//
// Bound: device memory. A pass reads and writes every amplitude once
// (16 B each); dense k = 4 costs 4^k complex MACs per group of 2^k, about
// 4 flop per byte, under the card's ~20 flop/B balance point.
// Design: one thread per group; the group's base index is the group number
// with zero bits inserted at the target positions; the 2^k values are
// loaded into registers before any write, y = U x is formed, and the
// results are written back to the same addresses. U is read straight from
// the kernel's parameters (the constant bank: every thread reads the same
// entry, a broadcast, at indices fixed at compile time). Staging it in
// shared memory first needed a copy loop with a run-time index into the
// parameters, which made the compiler copy the whole 2 KB parameter block
// to each thread's local memory (measured on an H100 at k = 4: 2.6 KB of
// stack, 34.7 ms per pass at n = 28 against 7.1 ms for the plain version).
// Targets on low bits make neighbouring threads touch interleaved
// addresses, so those passes gather partly uncoalesced sectors (the L1/L2
// absorb most of it); that is left as it is for now.
#include "common.cuh"

namespace {

template <int K>
struct GateArgs {
  int64_t off[1 << K];          // index offset of local index l (targets[0] = MSB)
  int pos_asc[K];               // target bit positions, ascending
  float2 u[(1 << K) * (1 << K)];  // U, row-major
};

template <int K>
__global__ void __launch_bounds__(qk::kThreads)
gate_kernel(float2* __restrict__ s, int64_t groups, const GateArgs<K> a) {
  constexpr int D = 1 << K;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const int64_t base = qk::insert_zero_bits<K>(g, a.pos_asc);
    float2 x[D];
#pragma unroll
    for (int l = 0; l < D; ++l) x[l] = s[base + a.off[l]];
#pragma unroll
    for (int r = 0; r < D; ++r) {
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int c = 0; c < D; ++c) acc = qk::cfma(a.u[r * D + c], x[c], acc);
      s[base + a.off[r]] = acc;
    }
  }
}

template <int K>
int launch_gate(float2* s, int64_t n, const int64_t* pos, const float2* u,
                cudaStream_t stream) {
  constexpr int D = 1 << K;
  GateArgs<K> a;
  for (int l = 0; l < D; ++l) {
    int64_t off = 0;
    for (int j = 0; j < K; ++j)
      if ((l >> (K - 1 - j)) & 1) off += int64_t(1) << pos[j];
    a.off[l] = off;
  }
  qk::sort_positions(pos, K, a.pos_asc);
  for (int t = 0; t < D * D; ++t) a.u[t] = u[t];
  const int64_t groups = int64_t(1) << (n - K);
  gate_kernel<K><<<qk::grid_for(groups, qk::kThreads), qk::kThreads, 0, stream>>>(s, groups, a);
  return (int)cudaGetLastError();
}

}  // namespace

// state: device float2[2^n]; pos: host int64[k], the bit position of each
// target in U's index order (targets[0] = MSB); u: host float2[4^k].
extern "C" int qk_gate(void* state, int64_t n, int k, const void* pos, const void* u,
                       int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (k < 1 || k > 4 || k > n) return (int)cudaErrorInvalidValue;
  float2* s = static_cast<float2*>(state);
  const int64_t* p = static_cast<const int64_t*>(pos);
  const float2* m = static_cast<const float2*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_gate<1>(s, n, p, m, st);
    case 2: return launch_gate<2>(s, n, p, m, st);
    case 3: return launch_gate<3>(s, n, p, m, st);
    default: return launch_gate<4>(s, n, p, m, st);
  }
}

extern "C" const char* qk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
