// A permutation of the index bits, in place: the value of bit p of every
// index moves to bit sigma(p), for an involution sigma (sigma(sigma(p)) = p).
// A run of qubit swaps, such as the QFT's final bit reversal, is one such
// permutation.
//
// Replaces: no TPU kernel. qubism_tpu/ops/fusion.py applies a swap as a
// dense 4 x 4 block, and a run of them as greedy <= 4-qubit blocks, each a
// pass of the gate kernel (K1). On this card each such pass moves the whole
// state once more, and a swap that pairs a low bit with a high bit makes
// neighbouring threads of the gate kernel touch interleaved addresses. The
// whole run is one relabelling of bits, so one pass suffices
// (ops/fusion.py forms it from the blocks; ops/kernels.py permute_prepare
// lays out the tiles below).
//
// Bound: device memory. The pass reads and writes every amplitude once
// (16 B each) and computes nothing.
// Design: the tile bits T are the low kColBits bits, their images under
// sigma, and further bits that sigma fixes or swaps among themselves, up to
// kTileBits; sigma maps T onto T, and the other bits R onto R. A tile is
// the 2^|T| amplitudes with one value r of the R bits: 2^(|T| - kColBits)
// rows of 2^kColBits contiguous amplitudes (512 B), so loads and stores
// stay coalesced. The tile of r is sent to the tile of sigma_R(r), permuted
// inside by sigma on T. One block takes a pair {r, sigma_R(r)} (r the
// smaller; a tile with sigma_R(r) = r alone): it copies both tiles into
// shared memory with cp.async (8 B a thread and copy, rows padded by one
// amplitude against bank conflicts), so all 64 KiB of the pair are in
// flight at once and no register holds them; waits, synchronises, and
// writes each tile into the other's place in 16-byte stores, every
// destination amplitude read from its source's slot. Tiles of different
// pairs are disjoint, so no block reads what another writes. Blocks loop
// over the rest values with a stride; a value whose partner is smaller is
// skipped. The layout comes in the kernel's parameters and every loop over
// it is unrolled to constant indices, so the parameters stay in the
// constant bank (see gate.cu). 66.5 KB of shared memory a block: three
// blocks an SM.
// Measured on an H100 at n = 30 (full bit reversal): 6.02 ms, 85% of the
// bound (`copy_` 91%). Tiles of 10 bits with 256 B rows, loaded through
// registers, read 63% (75 registers, three blocks an SM) and 73% (capped
// at 40, six blocks); with them cp.async prefetch of the next pair, loads
// batched in registers, one barrier an item, persistent grids and an order
// of rest values that keeps concurrent pairs contiguous did no better, and
// a tile permuted within itself read 82-85%. The wider rows and the larger
// pair in flight are what moved it.
#include "common.cuh"

namespace {

constexpr int kColBits = 6;    // amplitudes a row: 2^6 (512 B)
constexpr int kTileBits = 12;  // amplitudes a tile: at most 2^12
constexpr int kRowBits = kTileBits - kColBits;
constexpr int kMaxPairs = 16;  // pairs of swapped bits outside the tiles
constexpr int kStride = (1 << kColBits) + 1;  // a row in shared memory, padded
constexpr int kSmemBytes = 2 * (1 << kRowBits) * kStride * sizeof(float2);

// The packed layout (int32, ops/kernels.py permute_prepare's `packed`):
// col_bits, row_bits, tile_bits, pairs, tile[kTileBits] (ascending),
// rows[kRowBits] (the tile's bit positions above the columns, ascending),
// wcol[kColBits], wrow[kRowBits] (the shared-memory offset of the source
// of each destination column or row bit), pa[kMaxPairs], pb[kMaxPairs].
struct PermuteArgs {
  int col_bits, row_bits, tile_bits, pairs;
  int tile[kTileBits];
  int rows[kRowBits];
  int wcol[kColBits];
  int wrow[kRowBits];
  int pa[kMaxPairs], pb[kMaxPairs];
};
constexpr int kPackedInts = 4 + kTileBits + kRowBits + kColBits + kRowBits + 2 * kMaxPairs;
static_assert(sizeof(PermuteArgs) == kPackedInts * sizeof(int), "packed layout");

// 8 bytes from global to shared memory, asynchronously (sm_80 and later)
__device__ __forceinline__ void copy_async8(float2* dst, const float2* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__global__ void __launch_bounds__(qk::kThreads, 3)
permute_kernel(float2* __restrict__ s, int64_t items, const PermuteArgs a) {
  extern __shared__ float2 sm[];
  const int cols = 1 << a.col_bits;
  const int stride = cols + 1;
  const int tile_words = (1 << a.row_bits) * stride;
  const int tile_amps = 1 << a.tile_bits;
  const int vec_bits = a.col_bits - 1;  // float4s a row: 2^vec_bits
  const int tile_vecs = tile_amps >> 1;
  // a thread keeps its columns (a row's width divides the block): one
  // amplitude when it loads, two when it stores
  const int lcol = threadIdx.x & (cols - 1);
  const int c = (threadIdx.x & ((1 << vec_bits) - 1)) << 1;
  int ccol = 0;
#pragma unroll
  for (int j = 0; j < kColBits; ++j)
    if ((c >> j) & 1) ccol += a.wcol[j];
  for (int64_t r = blockIdx.x; r < items; r += gridDim.x) {
    int64_t base = r;  // the tile's first index: zero bits inserted at T
#pragma unroll
    for (int j = 0; j < kTileBits; ++j)
      if (j < a.tile_bits) {
        const int p = a.tile[j];
        base = ((base >> p) << (p + 1)) | (base & ((int64_t(1) << p) - 1));
      }
    int64_t other = base;  // sigma on the rest bits
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (k < a.pairs && (((other >> a.pa[k]) ^ (other >> a.pb[k])) & 1))
        other ^= (int64_t(1) << a.pa[k]) | (int64_t(1) << a.pb[k]);
    if (other < base) continue;  // the pair is the block's that holds `other`
    const int tiles = other == base ? 1 : 2;
    for (int f = threadIdx.x; f < tiles * tile_amps; f += blockDim.x) {
      const int sel = f >= tile_amps;
      const int row = (f - sel * tile_amps) >> a.col_bits;
      int64_t g = (sel ? other : base) + lcol;
#pragma unroll
      for (int j = 0; j < kRowBits; ++j)
        if ((row >> j) & 1) g += int64_t(1) << a.rows[j];
      copy_async8(sm + sel * tile_words + row * stride + lcol, s + g);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    for (int f = threadIdx.x; f < tiles * tile_vecs; f += blockDim.x) {
      const int sel = f >= tile_vecs;
      const int row = (f - sel * tile_vecs) >> vec_bits;
      int64_t g = (sel ? other : base) + c;
      int src = (tiles == 2 ? 1 - sel : 0) * tile_words + ccol;
#pragma unroll
      for (int j = 0; j < kRowBits; ++j)
        if ((row >> j) & 1) {
          g += int64_t(1) << a.rows[j];
          src += a.wrow[j];
        }
      const float2 y0 = sm[src], y1 = sm[src + a.wcol[0]];
      __stcs(reinterpret_cast<float4*>(s + g), make_float4(y0.x, y0.y, y1.x, y1.y));
    }
    __syncthreads();
  }
}

}  // namespace

// state: device float2[2^n], 16-byte aligned; layout: host int32[kPackedInts]
// from ops/kernels.py permute_prepare.
extern "C" int qk_permute(void* state, int64_t n, const void* layout, int device,
                          void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  PermuteArgs a;
  const int* p = static_cast<const int*>(layout);
  int* dst = reinterpret_cast<int*>(&a);
  for (int i = 0; i < kPackedInts; ++i) dst[i] = p[i];
  if (a.col_bits < 1 || a.col_bits > kColBits || a.row_bits < 0 || a.row_bits > kRowBits ||
      a.tile_bits != a.col_bits + a.row_bits || a.tile_bits > n || a.pairs < 0 ||
      a.pairs > kMaxPairs || (a.col_bits < kColBits && a.tile_bits != n))
    return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(permute_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int64_t items = int64_t(1) << (n - a.tile_bits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  permute_kernel<<<qk::grid_for(items, 1), qk::kThreads, kSmemBytes, st>>>(
      static_cast<float2*>(state), items, a);
  return (int)cudaGetLastError();
}
