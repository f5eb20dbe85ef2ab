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
// results are written back to the same addresses.
//
// One kernel serves two modes, which differ only in where U comes from:
// - the parameter mode reads U straight from the kernel's parameters (the
//   constant bank: every thread reads the same entry, a broadcast) at
//   indices fixed at compile time, so its row loop is unrolled. Staging
//   the parameters in shared memory needs a copy loop with a run-time index
//   into them, which made the compiler copy the whole 2 KB parameter block
//   to each thread's local memory (an H100 at k = 4: 2.6 KB of stack, 34.7
//   ms per pass at n = 28 against 7.1 ms for the plain version);
// - the device mode reads U from device memory (a matrix chosen on the
//   card, e.g. a trajectory's realized gate), staged once per block in
//   shared memory by a loop over global memory. Its row loop is not
//   unrolled, so one row of U (2^k values) is live at a time.
// In both, a thread takes ONE group and the grid covers every group: with a
// grid-stride loop the compiler hoists the shared entries of U out of the
// loop into registers (k = 4: 2.6 KB of stack, 34.8 ms at n = 28 on an
// H100). A row's address offset is formed from the target positions, at
// compile-time indices.
// Targets on low bits make neighbouring threads touch interleaved
// addresses, so those passes gather partly uncoalesced sectors (the L1/L2
// absorb most of it); that is left as it is for now.
#include "common.cuh"

namespace {

template <int K, bool kDev>
struct GateArgs {
  int pos[K];                                  // target bit positions in U's index
                                               // order (targets[0] = MSB)
  int pos_asc[K];                              // the same, ascending
  float2 u[kDev ? 1 : (1 << K) * (1 << K)];    // parameter mode: U, row-major
};

template <int K, bool kDev>
__global__ void __launch_bounds__(qk::kThreads)
gate_kernel(float2* __restrict__ s, int64_t groups, const float2* __restrict__ u,
            const GateArgs<K, kDev> a) {
  constexpr int D = 1 << K;
  __shared__ float2 su[kDev ? D * D : 1];
  if constexpr (kDev) {
    for (int t = threadIdx.x; t < D * D; t += blockDim.x) su[t] = u[t];
    __syncthreads();
  }
  const int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const int64_t base = qk::insert_zero_bits<K>(g, a.pos_asc);
  float2 x[D];
#pragma unroll
  for (int l = 0; l < D; ++l) {
    int64_t off = 0;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if ((l >> (K - 1 - j)) & 1) off += int64_t(1) << a.pos[j];
    x[l] = s[base + off];
  }
#pragma unroll (kDev ? 1 : D)
  for (int r = 0; r < D; ++r) {
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int c = 0; c < D; ++c) {
      if constexpr (kDev) acc = qk::cfma(su[r * D + c], x[c], acc);
      else acc = qk::cfma(a.u[r * D + c], x[c], acc);
    }
    int64_t off = 0;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if ((r >> (K - 1 - j)) & 1) off += int64_t(1) << a.pos[j];
    s[base + off] = acc;
  }
}

// u: host float2[4^k] (parameter mode) or device float2[4^k].
template <int K, bool kDev>
int launch_gate(float2* s, int64_t n, const int64_t* pos, const float2* u,
                cudaStream_t stream) {
  GateArgs<K, kDev> a;
  for (int j = 0; j < K; ++j) a.pos[j] = (int)pos[j];
  qk::sort_positions(pos, K, a.pos_asc);
  if constexpr (!kDev)
    for (int t = 0; t < (1 << K) * (1 << K); ++t) a.u[t] = u[t];
  const int64_t groups = int64_t(1) << (n - K);
  const unsigned int blocks = (unsigned int)((groups + qk::kThreads - 1) / qk::kThreads);
  gate_kernel<K, kDev><<<blocks, qk::kThreads, 0, stream>>>(s, groups, kDev ? u : nullptr, a);
  return (int)cudaGetLastError();
}

template <bool kDev>
int gate_entry(void* state, int64_t n, int k, const void* pos, const void* u, int device,
               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (k < 1 || k > 4 || k > n) return (int)cudaErrorInvalidValue;
  float2* s = static_cast<float2*>(state);
  const int64_t* p = static_cast<const int64_t*>(pos);
  const float2* m = static_cast<const float2*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_gate<1, kDev>(s, n, p, m, st);
    case 2: return launch_gate<2, kDev>(s, n, p, m, st);
    case 3: return launch_gate<3, kDev>(s, n, p, m, st);
    default: return launch_gate<4, kDev>(s, n, p, m, st);
  }
}

}  // namespace

// state: device float2[2^n]; pos: host int64[k], the bit position of each
// target in U's index order (targets[0] = MSB); u: host float2[4^k].
extern "C" int qk_gate(void* state, int64_t n, int k, const void* pos, const void* u,
                       int device, void* stream) {
  return gate_entry<false>(state, n, k, pos, u, device, stream);
}

// As qk_gate, with u: device float2[4^k] (row-major, 8-byte aligned).
extern "C" int qk_gate_dev(void* state, int64_t n, int k, const void* pos, const void* u,
                           int device, void* stream) {
  return gate_entry<true>(state, n, k, pos, u, device, stream);
}

extern "C" const char* qk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
