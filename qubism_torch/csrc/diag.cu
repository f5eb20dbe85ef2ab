// K2: the state times a product of commuting diagonal factors, in one pass.
//
// Replaces: qubism_tpu/ops/kernels.py::_diag_pass_fn (host side
// _diag_tables / _split_factor_phases / _diag_groups; entries
// diag_layer_prepare / diag_layer). The TPU kernel factored every factor
// into row x lane tables of its (R, 2048) tile and capped the straddling
// terms per pass; here each factor is indexed directly by the bits of the
// amplitude index at its targets.
//
// Bound: device memory (one read and one write of each amplitude; the
// table lookups hit shared memory). What has to stay small is the number
// of instructions per amplitude.
// Design (diag_kernel): the tables of all factors of the pass (complex64,
// concatenated) and one descriptor per factor sit in shared memory. A
// thread owns 2^M 16-byte vectors of two neighbouring amplitudes (M <= 3:
// 16 amplitudes), which differ only in index bit 0 and in M "thread bits"
// that the host picks per pass, at positions >= 6 (so a warp still reads
// and writes 512 contiguous bytes per vector) that as few factors as
// possible touch. A factor that touches none of those bits has the same
// entry for all the thread's amplitudes: the descriptors list such factors
// first, and the thread gathers each one's table index once and folds them
// into one product. Only the other factors are evaluated per amplitude, and
// for them the descriptor holds the index contribution of each of the 2^(M+1)
// positions, so an amplitude costs an add, a shared-memory load and a complex
// multiply. The gather itself is compiled on the host into runs of
// neighbouring bits: index |= ((base >> shift) & mask) << left.
//
// A descriptor is kDescWords int32 words. A table factor: word 0 = number
// of runs, 1 = table offset, 2.. = runs as shift | mask << 8 | left << 16,
// 12..15 = the positions' index contributions, one byte each. A (mask,
// value, phase) factor (word 0 = -1; the form a factor wider than 7 qubits
// takes on the host): words 2, 3 = mask and 4, 5 = value over the bits that
// are not the thread's own, 6 = the set of positions whose own bits match;
// it multiplies by the phase at table offset word 1 where both hold.
//
// One factor on one or two qubits (what a single cu1, rz or cz launches)
// takes diag1_kernel: the table in the kernel parameters, no shared memory,
// no descriptor. A state of one amplitude (n = 0) takes diag_scalar_kernel.
#include "common.cuh"

namespace {

constexpr int kDescWords = 16;
constexpr int kRunWord = 2, kDeltaWord = 12, kMaxThreadBits = 3;
// shared-memory operands up to this many bytes are refilled by one block per
// 4096 amplitudes; larger ones by a persistent grid (see blocks_for)
constexpr size_t kSmallOperands = 2048;

// zero bit inserted at position p
__device__ __forceinline__ int64_t open_bit(int64_t v, int p) {
  return ((v >> p) << (p + 1)) | (v & ((int64_t(1) << p) - 1));
}

// table index (offset included) of a table factor at amplitude index `base`
__device__ __forceinline__ int gather(const int* d, int64_t base) {
  int idx = d[1];
  for (int r = 0; r < d[0]; ++r) {
    const int w = d[kRunWord + r];
    idx += (int(base >> (w & 63)) & ((w >> 8) & 127)) << (w >> 16);
  }
  return idx;
}

__device__ __forceinline__ bool mask_hit(const int* d, int64_t base) {
  const uint64_t mask = uint64_t(uint32_t(d[2])) | (uint64_t(uint32_t(d[3])) << 32);
  const uint64_t value = uint64_t(uint32_t(d[4])) | (uint64_t(uint32_t(d[5])) << 32);
  return (uint64_t(base) & mask) == value;
}

template <int M>
__global__ void __launch_bounds__(qk::kThreads)
diag_kernel(float4* __restrict__ s, int64_t items, const float2* __restrict__ tables, int ntab,
            const int* __restrict__ desc, int nfac, int ninv, int p0, int p1, int p2) {
  constexpr int J = 1 << M;
  extern __shared__ float2 smem[];
  float2* tab = smem;
  int* dsc = reinterpret_cast<int*>(smem + ntab);
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) tab[i] = tables[i];
  for (int i = threadIdx.x; i < nfac * kDescWords; i += blockDim.x) dsc[i] = desc[i];
  __syncthreads();
  // vector j of the thread lies voff[j] vectors above its first
  int64_t voff[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    voff[j] = ((j & 1) ? int64_t(1) << (p0 - 1) : 0) + ((j & 2) ? int64_t(1) << (p1 - 1) : 0) +
              ((j & 4) ? int64_t(1) << (p2 - 1) : 0);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t item = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; item < items;
       item += stride) {
    int64_t base = item << 1;  // bit 0 and the thread bits (ascending) read 0
    if (M > 0) base = open_bit(base, p0);
    if (M > 1) base = open_bit(base, p1);
    if (M > 2) base = open_bit(base, p2);
    float4* at = s + (base >> 1);
    float4 v[J];
#pragma unroll
    for (int j = 0; j < J; ++j) v[j] = at[voff[j]];

    float2 common = make_float2(1.f, 0.f);
    for (int f = 0; f < ninv; ++f) {
      const int* d = dsc + f * kDescWords;
      if (d[0] >= 0) {
        common = qk::cmul(common, tab[gather(d, base)]);
      } else if (mask_hit(d, base)) {
        common = qk::cmul(common, tab[d[1]]);
      }
    }
    if (ninv == nfac) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float2 lo = qk::cmul(make_float2(v[j].x, v[j].y), common);
        const float2 hi = qk::cmul(make_float2(v[j].z, v[j].w), common);
        at[voff[j]] = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      continue;
    }
    float2 a[2 * J];  // position c: vector c >> 1, amplitude c & 1 of it
#pragma unroll
    for (int c = 0; c < 2 * J; ++c) a[c] = common;
    for (int f = ninv; f < nfac; ++f) {
      const int* d = dsc + f * kDescWords;
      if (d[0] >= 0) {
        const int idx = gather(d, base);
#pragma unroll
        for (int c = 0; c < 2 * J; ++c)
          a[c] = qk::cmul(a[c], tab[idx + ((d[kDeltaWord + (c >> 2)] >> (8 * (c & 3))) & 255)]);
      } else if (mask_hit(d, base)) {
        const float2 ph = tab[d[1]];
        const int sel = d[6];
#pragma unroll
        for (int c = 0; c < 2 * J; ++c)
          if ((sel >> c) & 1) a[c] = qk::cmul(a[c], ph);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float2 lo = qk::cmul(make_float2(v[j].x, v[j].y), a[2 * j]);
      const float2 hi = qk::cmul(make_float2(v[j].z, v[j].w), a[2 * j + 1]);
      at[voff[j]] = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }
}

// n = 0: every table factor is read at index 0.
__global__ void diag_scalar_kernel(float2* __restrict__ s, const float2* __restrict__ tables,
                                   const int* __restrict__ desc, int nfac) {
  float2 acc = s[0];
  for (int f = 0; f < nfac; ++f) {
    const int* d = desc + f * kDescWords;
    if (d[0] >= 0 || mask_hit(d, 0)) acc = qk::cmul(acc, tables[d[1]]);
  }
  s[0] = acc;
}

struct Table4 {
  float2 v[4];
};

constexpr int kOneVecs = 4;  // 16-byte vectors per thread and step

// One factor on K <= 2 qubits at bit positions p0 (MSB of its index), p1.
template <int K>
__global__ void __launch_bounds__(qk::kThreads)
diag1_kernel(float4* __restrict__ s, int64_t vecs, int p0, int p1, Table4 t) {
  auto entry = [&](int64_t i) {
    const bool b0 = (i >> p0) & 1;
    if (K == 1) return b0 ? t.v[1] : t.v[0];
    const bool b1 = (i >> p1) & 1;
    const float2 lo = b1 ? t.v[1] : t.v[0];
    const float2 hi = b1 ? t.v[3] : t.v[2];
    return b0 ? hi : lo;
  };
  const int64_t chunk = int64_t(blockDim.x) * kOneVecs;
  for (int64_t v0 = int64_t(blockIdx.x) * chunk + threadIdx.x; v0 < vecs;
       v0 += int64_t(gridDim.x) * chunk) {
    float4 x[kOneVecs];
#pragma unroll
    for (int j = 0; j < kOneVecs; ++j)
      if (v0 + j * blockDim.x < vecs) x[j] = s[v0 + j * blockDim.x];
#pragma unroll
    for (int j = 0; j < kOneVecs; ++j) {
      const int64_t v = v0 + j * blockDim.x;
      if (v >= vecs) continue;
      const float2 lo = qk::cmul(make_float2(x[j].x, x[j].y), entry(2 * v));
      const float2 hi = qk::cmul(make_float2(x[j].z, x[j].w), entry(2 * v + 1));
      s[v] = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }
}

// Blocks of qk::kThreads threads for `work` thread items. `persistent`: 8
// blocks per SM that stride over the items (a block's shared-memory operands
// are then filled few times); else one item per thread, which keeps more
// loads in flight and measured 5-7% faster where the operands are small.
int blocks_for(int64_t work, int device, bool persistent, cudaError_t* e) {
  int sms = 0;
  *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const unsigned int need = qk::grid_for(work, qk::kThreads);
  const unsigned int cap = 8u * (unsigned int)sms;
  return (int)(persistent && need > cap ? cap : need);
}

}  // namespace

// state: device float2[2^n], 16-byte aligned; tables: device float2[ntab];
// desc: device int32[nfac][16], the first ninv of them factors that touch
// neither bit 0 nor a thread bit; own: host int32[m], the thread bits,
// ascending, each in [1, n). The caller keeps ntab * 8 + nfac * 64 bytes
// within the 48 KB of shared memory a block has without opting in.
extern "C" int qk_diag(void* state, int64_t n, const void* tables, int64_t ntab,
                       const void* desc, int nfac, int ninv, int m, const int* own, int device,
                       void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = size_t(ntab) * sizeof(float2) + size_t(nfac) * kDescWords * sizeof(int);
  if (ntab < 1 || nfac < 1 || ninv < 0 || ninv > nfac || smem > 48 * 1024 || m < 0 ||
      m > kMaxThreadBits || (n > 0 && m > n - 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* tab = static_cast<const float2*>(tables);
  const int* dsc = static_cast<const int*>(desc);
  if (n == 0) {
    diag_scalar_kernel<<<1, 1, 0, st>>>(static_cast<float2*>(state), tab, dsc, nfac);
    return (int)cudaGetLastError();
  }
  int p[kMaxThreadBits] = {1, 1, 1};
  for (int j = 0; j < m; ++j) {
    p[j] = own[j];
    if (p[j] < 1 || p[j] >= n || (j > 0 && p[j] <= p[j - 1])) return (int)cudaErrorInvalidValue;
  }
  const int64_t items = (int64_t(1) << n) >> (1 + m);
  const int blocks = blocks_for(items, device, smem > kSmallOperands, &e);
  if (e != cudaSuccess) return (int)e;
  float4* s = static_cast<float4*>(state);
#define QK_DIAG(M)                                                                       \
  diag_kernel<M><<<blocks, qk::kThreads, smem, st>>>(s, items, tab, (int)ntab, dsc, nfac, \
                                                     ninv, p[0], p[1], p[2])
  switch (m) {
    case 0: QK_DIAG(0); break;
    case 1: QK_DIAG(1); break;
    case 2: QK_DIAG(2); break;
    default: QK_DIAG(3); break;
  }
#undef QK_DIAG
  return (int)cudaGetLastError();
}

// One factor on k = 1 or 2 qubits: pos: host int64[k], the bit positions of
// its targets (MSB of the table index first); table: host float2[2^k].
extern "C" int qk_diag1(void* state, int64_t n, int k, const int64_t* pos, const void* table,
                        int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n < 1 || k < 1 || k > 2) return (int)cudaErrorInvalidValue;
  Table4 t;
  for (int i = 0; i < 4; ++i) t.v[i] = static_cast<const float2*>(table)[i < (1 << k) ? i : 0];
  const int64_t vecs = int64_t(1) << (n - 1);
  const int blocks = blocks_for((vecs + kOneVecs - 1) / kOneVecs, device, false, &e);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* s = static_cast<float4*>(state);
  if (k == 1) {
    diag1_kernel<1><<<blocks, qk::kThreads, 0, st>>>(s, vecs, (int)pos[0], 0, t);
  } else {
    diag1_kernel<2><<<blocks, qk::kThreads, 0, st>>>(s, vecs, (int)pos[0], (int)pos[1], t);
  }
  return (int)cudaGetLastError();
}
