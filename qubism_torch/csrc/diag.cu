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
// table lookups hit shared memory).
// Design: the tables of all factors of the pass (complex64, concatenated)
// and one descriptor per factor sit in shared memory. A descriptor is
// W int32 words: k, table offset, mask (lo, hi), then k bit positions, MSB
// of the table index first. k = 0 marks a (mask, value, phase) factor, the
// form a factor wider than 7 qubits takes on the host (one phase per point
// where it differs from its common value, or else the exact Moebius split):
// it multiplies where the bits under the mask read the value (words 4, 5;
// mask 0: everywhere). One
// thread per amplitude (grid-stride): product of the factors' entries, one
// complex multiply of the amplitude, one write to the same address.
#include "common.cuh"

namespace {

constexpr int kDescWords = 12;

__global__ void __launch_bounds__(qk::kThreads)
diag_kernel(float2* __restrict__ s, int64_t size, const float2* __restrict__ tables,
            int ntab, const int* __restrict__ desc, int nfac) {
  extern __shared__ float2 smem[];
  float2* tab = smem;
  int* dsc = reinterpret_cast<int*>(smem + ntab);
  for (int t = threadIdx.x; t < ntab; t += blockDim.x) tab[t] = tables[t];
  for (int t = threadIdx.x; t < nfac * kDescWords; t += blockDim.x) dsc[t] = desc[t];
  __syncthreads();
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < size; i += stride) {
    float2 acc = make_float2(1.f, 0.f);
    for (int f = 0; f < nfac; ++f) {
      const int* d = dsc + f * kDescWords;
      const int k = d[0];
      if (k > 0) {
        int idx = 0;
        for (int j = 0; j < k; ++j) idx = (idx << 1) | int((i >> d[4 + j]) & 1);
        acc = qk::cmul(acc, tab[d[1] + idx]);
      } else {
        const uint64_t mask = uint64_t(uint32_t(d[2])) | (uint64_t(uint32_t(d[3])) << 32);
        const uint64_t value = uint64_t(uint32_t(d[4])) | (uint64_t(uint32_t(d[5])) << 32);
        if ((uint64_t(i) & mask) == value) acc = qk::cmul(acc, tab[d[1]]);
      }
    }
    s[i] = qk::cmul(s[i], acc);
  }
}

}  // namespace

// state: device float2[2^n]; tables: device float2[ntab]; desc: device
// int32[nfac][12]. The caller keeps ntab * 8 + nfac * 48 bytes within the
// 48 KB of shared memory a block has without opting in.
extern "C" int qk_diag(void* state, int64_t n, const void* tables, int64_t ntab,
                       const void* desc, int nfac, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = size_t(ntab) * sizeof(float2) + size_t(nfac) * kDescWords * sizeof(int);
  if (ntab < 1 || nfac < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int64_t size = int64_t(1) << n;
  diag_kernel<<<qk::grid_for(size, qk::kThreads), qk::kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(state), size, static_cast<const float2*>(tables), (int)ntab,
      static_cast<const int*>(desc), nfac);
  return (int)cudaGetLastError();
}
