// K4: m <= 6 single-qubit gates on distinct qubits, in one pass.
//
// Replaces: qubism_tpu/ops/kernels.py::_layer1q_fn (entry layer1q_prepare),
// which applied the gates one after another to each (R, 2048) tile while it
// sat in VMEM, reaching targets as block slots or rolls.
//
// Bound: device memory. Each gate costs 2 complex MACs per amplitude
// (at m = 6: ~3 flop per byte moved), far below the card's balance point,
// so the pass should run near the bandwidth of a copy.
// Design: one thread per group of 2^m amplitudes over all m targets (the
// group number with zero bits inserted at the target positions). The thread
// loads the 2^m values into registers, applies each 2x2 gate as in-register
// butterflies over the local bit of its target, and writes the group back.
// Everything is unrolled on m, so the group stays in registers; at m = 6 a
// thread holds 64 complex values (128 registers), which is why m stops at 6
// (compile with -Xptxas -v to see the count and the spill).
//
// One kernel serves two modes, which differ only in where the 4m gate
// entries come from: the kernel parameters (gates fixed on the host), or
// device memory (gates chosen on the card: an MCWF branch scaled by its
// norm, a deferred Kraus composed into a gate), staged once per block in
// shared memory. Both read them at indices fixed at compile time. A thread
// takes ONE group and the grid covers every group: with a grid-stride loop
// the compiler hoists the 4m entries out of the loop into registers, on top
// of the group's values (m = 6, n = 28 on an H100: with the loop, 176 bytes
// of spill in the device mode, and 104 bytes and 1.84 ms a pass in the
// parameter mode; the device mode with one group per thread spilled 56
// bytes and took 1.51 ms).
#include "common.cuh"

namespace {

template <int M, bool kDev>
struct Layer1QArgs {
  int64_t off[1 << M];          // index offset of local index l (gate 0 = MSB)
  int pos_asc[M];               // target bit positions, ascending
  float2 g[kDev ? 1 : M][4];    // parameter mode: gate j's u00 u01 u10 u11
};

template <int M, bool kDev>
__global__ void __launch_bounds__(qk::kThreads)
layer1q_kernel(float2* __restrict__ s, int64_t groups, const float2* __restrict__ gates,
               const Layer1QArgs<M, kDev> a) {
  constexpr int D = 1 << M;
  __shared__ float2 sg[kDev ? 4 * M : 1];
  if constexpr (kDev) {
    for (int t = threadIdx.x; t < 4 * M; t += blockDim.x) sg[t] = gates[t];
    __syncthreads();
  }
  const int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const int64_t base = qk::insert_zero_bits<M>(g, a.pos_asc);
  float2 x[D];
#pragma unroll
  for (int l = 0; l < D; ++l) x[l] = s[base + a.off[l]];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int bit = 1 << (M - 1 - j);
    float2 u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kDev) u[e] = sg[4 * j + e];
      else u[e] = a.g[j][e];
    }
#pragma unroll
    for (int l = 0; l < D; ++l) {
      if (l & bit) continue;
      const float2 x0 = x[l], x1 = x[l | bit];
      x[l] = qk::cfma(u[1], x1, qk::cmul(u[0], x0));
      x[l | bit] = qk::cfma(u[3], x1, qk::cmul(u[2], x0));
    }
  }
#pragma unroll
  for (int l = 0; l < D; ++l) s[base + a.off[l]] = x[l];
}

// g: host float2[m][2][2] (parameter mode) or device float2[m][2][2].
template <int M, bool kDev>
int launch_layer1q(float2* s, int64_t n, const int64_t* pos, const float2* g,
                   cudaStream_t stream) {
  constexpr int D = 1 << M;
  Layer1QArgs<M, kDev> a;
  for (int l = 0; l < D; ++l) {
    int64_t off = 0;
    for (int j = 0; j < M; ++j)
      if ((l >> (M - 1 - j)) & 1) off += int64_t(1) << pos[j];
    a.off[l] = off;
  }
  qk::sort_positions(pos, M, a.pos_asc);
  if constexpr (!kDev)
    for (int j = 0; j < M; ++j)
      for (int e = 0; e < 4; ++e) a.g[j][e] = g[4 * j + e];
  const int64_t groups = int64_t(1) << (n - M);
  const unsigned int blocks = (unsigned int)((groups + qk::kThreads - 1) / qk::kThreads);
  layer1q_kernel<M, kDev><<<blocks, qk::kThreads, 0, stream>>>(s, groups, kDev ? g : nullptr, a);
  return (int)cudaGetLastError();
}

template <bool kDev>
int layer1q_entry(void* state, int64_t n, int m, const void* pos, const void* gates,
                  int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (m < 1 || m > 6 || m > n) return (int)cudaErrorInvalidValue;
  float2* s = static_cast<float2*>(state);
  const int64_t* p = static_cast<const int64_t*>(pos);
  const float2* g = static_cast<const float2*>(gates);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return launch_layer1q<1, kDev>(s, n, p, g, st);
    case 2: return launch_layer1q<2, kDev>(s, n, p, g, st);
    case 3: return launch_layer1q<3, kDev>(s, n, p, g, st);
    case 4: return launch_layer1q<4, kDev>(s, n, p, g, st);
    case 5: return launch_layer1q<5, kDev>(s, n, p, g, st);
    default: return launch_layer1q<6, kDev>(s, n, p, g, st);
  }
}

}  // namespace

// state: device float2[2^n]; pos: host int64[m], the bit position of each
// gate's qubit; gates: host float2[m][2][2].
extern "C" int qk_layer1q(void* state, int64_t n, int m, const void* pos, const void* gates,
                          int device, void* stream) {
  return layer1q_entry<false>(state, n, m, pos, gates, device, stream);
}

// As qk_layer1q, with gates: device float2[m][2][2] (8-byte aligned).
extern "C" int qk_layer1q_dev(void* state, int64_t n, int m, const void* pos,
                              const void* gates, int device, void* stream) {
  return layer1q_entry<true>(state, n, m, pos, gates, device, stream);
}
