// K5: a block of k <= 4 QFT stages in one pass. A stage is a 1q gate U_t on
// qubit q_t followed by a ladder of 2q diagonals (q_t, j), j > q_t, whose
// branch q_t = 0 is the identity; the block's qubits q_1 < ... < q_k are
// consecutive, so every ladder bit j outside the block lies below all of
// the block's bits in the amplitude index.
//
// Replaces: qubism_tpu/ops/kernels.py::_gate_fn with stage = 1..4 (host side
// stage_block_prepare / _phase_tables). The TPU kernel factored each
// stage's outside-ladder phase into a (rows x lanes) table pair of its
// (R, 2048) tile; here it is looked up per group from byte tables.
//
// What the pass computes, for each group of the 2^k amplitudes that share
// every non-target bit:
//     y(i) = prod_{t : bit t of i is 1} P_t(g) * sum_j C[i][j] x(j)
// C is the host-folded 2^k x 2^k block (the 1q gates times the ladder
// factors between the block's own qubits); P_t(g) is stage t's phase from
// its ladder factors outside the block, which depends only on index bits
// below the lowest target, so it is the same for the whole group.
//
// Bound: device memory. Each amplitude is read and written once (16 B);
// k = 4 adds 16 complex MACs plus at most 4 table lookups per amplitude.
// Design: as gate.cu, one thread per group: the group's base index is the
// group number with zero bits inserted at the target positions, the 2^k
// values are loaded before any write, and C is read from the kernel
// parameters at indices fixed at compile time (the constant bank). The
// ladder phase P_t is the product of one lookup per byte of the low index
// bits: the host builds, per stage and per byte chunk, a 256-entry complex
// table (chunks <= 4, so at most 4 x 4 x 2 KB = 32 KB), and each block
// stages all of them in shared memory once. The grid is capped so that the
// staging is amortised over many groups per block.
#include "common.cuh"

namespace {

constexpr int kChunkBits = 8;
constexpr int kChunkSize = 1 << kChunkBits;
constexpr int kMaxChunks = 4;
// grid cap: 2048 blocks x 256 threads fill the card's 132 SMs several times
constexpr int64_t kStageBlocks = 2048;

template <int K>
struct StageArgs {
  int64_t off[1 << K];            // index offset of local index l (stage 0 = MSB)
  int pos_asc[K];                 // target bit positions, ascending
  float2 c[(1 << K) * (1 << K)];  // the folded block C, row-major
};

template <int K>
__global__ void __launch_bounds__(qk::kThreads)
stage_kernel(float2* __restrict__ s, int64_t groups, const float2* __restrict__ tables,
             int chunks, const StageArgs<K> a) {
  constexpr int D = 1 << K;
  extern __shared__ float2 tab[];  // tab[(t * chunks + c) * 256 + byte]
  for (int i = threadIdx.x; i < K * chunks * kChunkSize; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const int64_t base = qk::insert_zero_bits<K>(g, a.pos_asc);
    float2 x[D];
#pragma unroll
    for (int l = 0; l < D; ++l) x[l] = s[base + a.off[l]];
    // the bits below the lowest target are the same in g and in base
    float2 p[K];
#pragma unroll
    for (int t = 0; t < K; ++t) p[t] = make_float2(1.f, 0.f);
    for (int c = 0; c < chunks; ++c) {
      const int e = int((g >> (c * kChunkBits)) & (kChunkSize - 1));
#pragma unroll
      for (int t = 0; t < K; ++t) p[t] = qk::cmul(p[t], tab[(t * chunks + c) * kChunkSize + e]);
    }
#pragma unroll
    for (int r = 0; r < D; ++r) {
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int c = 0; c < D; ++c) acc = qk::cfma(a.c[r * D + c], x[c], acc);
#pragma unroll
      for (int t = 0; t < K; ++t)
        if ((r >> (K - 1 - t)) & 1) acc = qk::cmul(acc, p[t]);
      s[base + a.off[r]] = acc;
    }
  }
}

template <int K>
int launch_stage(float2* s, int64_t n, const int64_t* pos, const float2* cm,
                 const float2* tables, int chunks, cudaStream_t stream) {
  constexpr int D = 1 << K;
  StageArgs<K> a;
  for (int l = 0; l < D; ++l) {
    int64_t off = 0;
    for (int j = 0; j < K; ++j)
      if ((l >> (K - 1 - j)) & 1) off += int64_t(1) << pos[j];
    a.off[l] = off;
  }
  qk::sort_positions(pos, K, a.pos_asc);
  for (int t = 0; t < D * D; ++t) a.c[t] = cm[t];
  const int64_t groups = int64_t(1) << (n - K);
  unsigned int blocks = qk::grid_for(groups, qk::kThreads);
  if (blocks > kStageBlocks) blocks = (unsigned int)kStageBlocks;
  const size_t smem = size_t(K) * chunks * kChunkSize * sizeof(float2);
  stage_kernel<K><<<blocks, qk::kThreads, smem, stream>>>(s, groups, tables, chunks, a);
  return (int)cudaGetLastError();
}

}  // namespace

// state: device float2[2^n]; pos: host int64[k], the bit position of each
// stage's qubit in C's index order (stage 0 = MSB); c: host float2[4^k];
// tables: device float2[k][chunks][256] (null when chunks = 0).
extern "C" int qk_stage(void* state, int64_t n, int k, const void* pos, const void* c,
                        const void* tables, int chunks, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (k < 1 || k > 4 || k > n || chunks < 0 || chunks > kMaxChunks ||
      (chunks > 0 && tables == nullptr))
    return (int)cudaErrorInvalidValue;
  float2* s = static_cast<float2*>(state);
  const int64_t* p = static_cast<const int64_t*>(pos);
  const float2* m = static_cast<const float2*>(c);
  const float2* tb = static_cast<const float2*>(tables);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_stage<1>(s, n, p, m, tb, chunks, st);
    case 2: return launch_stage<2>(s, n, p, m, tb, chunks, st);
    case 3: return launch_stage<3>(s, n, p, m, tb, chunks, st);
    default: return launch_stage<4>(s, n, p, m, tb, chunks, st);
  }
}
