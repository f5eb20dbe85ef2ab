// The HBM bandwidth probes: the simplest passes over a complex64 state of
// 2^n amplitudes, one access pattern each, so that the engine's kernels can
// be read against what the card sustains for that pattern.
//
// Replaces 8 of the 11 pallas_call sites of experiments/bw_probe.py (the
// copy and read passes, make_pallas_copy (:81) and make_pallas_read_only
// (:189), are csrc/probe_copy_read.cu):
//
// * qk_probe_stream, a streaming pass in one of two modes:
//   phase  dst = src * (c1 + i c2)        make_pallas_phase (:50),
//          (dst == src: in place)         make_pallas_phase_noalias (:157),
//                                         phase2d in main_canon (:573)
//   write  re = v, im = v / 2, v = *seed  make_pallas_write_only (:220)
// * qk_probe_pair, one qubit q at stride s = 2^(n-1-q):
//   y0 = a x0 + b x1, y1 = (c x0 + d x1) p, with p = row[b] * lane[c] where
//   the tables are given (else 1 and the constant pc):
//                                         make_stage (:258),
//                                         make_stage_flat (:300),
//                                         make_stage_tables (:351),
//                                         make_roll_butterfly (:456).
//   (make_lane_matmul_canonical (:506) is K3, csrc/lane.cu.)
//
// Bound: device memory, by construction. phase and pair read and write
// 16 B per amplitude, write writes 8 B; the pair probe's tables add B + C
// complex values. At most ~3 flop per byte moved, far below the card's
// balance point.
//
// Design: 16-byte accesses (a float4 is two amplitudes) in a grid-stride
// loop. A block of T threads handles T * VEC float4s per step: access j of
// thread t is float4 base + j * T + t, so every access of a warp is one
// contiguous 512-byte run. The launch geometry (T, VEC) is the knob the
// TPU's (BR, C) block shapes stood for; the kernels are templated on VEC,
// which keeps VEC independent loads in flight per thread. The write probe
// reads its seed from a separate one-element buffer that the caller copied
// out of the state first: read from the state itself, the result would
// depend on which block overwrote element 0 first.
// The pair kernel takes two adjacent pairs per item (s >= 2), so its loads
// of x0 and x1 are two 16-byte accesses; at s = 1 a pair is one float4. Its
// 2x2 coefficients and constant phase travel in the kernel parameters (read
// at fixed offsets: the constant bank), the optional tables stay in device
// memory and are read through the cache.
//
// CUDA rather than Triton: the port's build already compiles csrc/*.cu, and
// these passes are what the CUDA kernels' numbers get compared with.
#include "common.cuh"

namespace {

enum Mode { kPhase = 1, kWrite = 3 };

constexpr int kMaxThreads = 1024;
constexpr int kPairMaxThreads = 512;

__device__ __forceinline__ float4 phase2(float4 x, float2 c) {
  return make_float4(x.x * c.x - x.y * c.y, x.x * c.y + x.y * c.x,
                     x.z * c.x - x.w * c.y, x.z * c.y + x.w * c.x);
}

template <int MODE, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
stream_kernel(const float4* src, float4* dst, int64_t items, float2 c, const float* seed) {
  const int64_t tile = int64_t(blockDim.x) * VEC;
  const int64_t step = tile * gridDim.x;
  float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
  if (MODE == kWrite) {
    const float v = *seed;
    w = make_float4(v, 0.5f * v, v, 0.5f * v);
  }
  for (int64_t base = int64_t(blockIdx.x) * tile + threadIdx.x; base < items; base += step) {
    float4 x[VEC];
    if (MODE != kWrite) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int64_t i = base + int64_t(j) * blockDim.x;
        x[j] = i < items ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int64_t i = base + int64_t(j) * blockDim.x;
      if (i < items) {
        if (MODE == kPhase) dst[i] = phase2(x[j], c);
        if (MODE == kWrite) dst[i] = w;
      }
    }
  }
}

struct PairArgs {
  float2 a, b, c, d;  // y0 = a x0 + b x1, y1 = (c x0 + d x1) p
  float2 pc;          // p's lane factor where there is no lane table
  int sbits;          // s = 2^sbits, the distance from x0 to x1
  int cbits;          // C = 2^cbits: offset o in the tail is (o >> cbits, o & (C-1))
};

// p for the pair at offset o of its tail.
__device__ __forceinline__ float2 pair_phase(const PairArgs& a, int64_t o, const float2* row,
                                             const float2* lane) {
  float2 p = lane ? lane[o & ((int64_t(1) << a.cbits) - 1)] : a.pc;
  if (row) p = qk::cmul(row[o >> a.cbits], p);
  return p;
}

__device__ __forceinline__ void butterfly(const PairArgs& a, float2 x0, float2 x1, float2 p,
                                          float2& y0, float2& y1) {
  y0 = qk::cfma(a.b, x1, qk::cmul(a.a, x0));
  y1 = qk::cmul(qk::cfma(a.d, x1, qk::cmul(a.c, x0)), p);
}

// WIDE (s >= 2): item h is the pairs g = 2h and 2h + 1, whose x0s are one
// float4 and whose x1s are the float4 s/2 further on. Otherwise (s = 1)
// item h is pair h, one float4 (x0, x1).
template <int VEC, bool WIDE>
__global__ void __launch_bounds__(kPairMaxThreads)
pair_kernel(const float4* src, float4* dst, int64_t items, const PairArgs a, const float2* row,
            const float2* lane) {
  const int64_t tile = int64_t(blockDim.x) * VEC;
  const int64_t step = tile * gridDim.x;
  const int64_t smask = (int64_t(1) << a.sbits) - 1;
  for (int64_t base = int64_t(blockIdx.x) * tile + threadIdx.x; base < items; base += step) {
    float4 x0[VEC], x1[VEC];
    int64_t at[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int64_t h = base + int64_t(j) * blockDim.x;
      x0[j] = x1[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      at[j] = 0;
      if (h < items) {
        if (WIDE) {
          const int64_t g = 2 * h;
          at[j] = (((g >> a.sbits) << (a.sbits + 1)) | (g & smask)) >> 1;
          x0[j] = src[at[j]];
          x1[j] = src[at[j] + (smask + 1) / 2];
        } else {
          at[j] = h;
          x0[j] = src[h];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int64_t h = base + int64_t(j) * blockDim.x;
      if (h >= items) continue;
      float2 y0, y1, z0, z1;
      if (WIDE) {
        const int64_t o = (2 * h) & smask;
        butterfly(a, make_float2(x0[j].x, x0[j].y), make_float2(x1[j].x, x1[j].y),
                  pair_phase(a, o, row, lane), y0, y1);
        butterfly(a, make_float2(x0[j].z, x0[j].w), make_float2(x1[j].z, x1[j].w),
                  pair_phase(a, o + 1, row, lane), z0, z1);
        dst[at[j]] = make_float4(y0.x, y0.y, z0.x, z0.y);
        dst[at[j] + (smask + 1) / 2] = make_float4(y1.x, y1.y, z1.x, z1.y);
      } else {
        butterfly(a, make_float2(x0[j].x, x0[j].y), make_float2(x0[j].z, x0[j].w),
                  pair_phase(a, 0, row, lane), y0, y1);
        dst[at[j]] = make_float4(y0.x, y0.y, y1.x, y1.y);
      }
    }
  }
}

bool geometry_ok(int threads, int vec, int max_threads) {
  return threads >= 32 && threads <= max_threads && threads % 32 == 0 &&
         (vec == 1 || vec == 2 || vec == 4);
}

unsigned int blocks_for(int64_t items, int threads, int vec) {
  return qk::grid_for((items + vec - 1) / vec, threads);
}

template <int MODE>
void launch_stream_vec(int vec, const float4* src, float4* dst, int64_t items, float2 c,
                       const float* seed, unsigned int blocks, int threads, cudaStream_t st) {
  switch (vec) {
    case 1: stream_kernel<MODE, 1><<<blocks, threads, 0, st>>>(src, dst, items, c, seed); break;
    case 2: stream_kernel<MODE, 2><<<blocks, threads, 0, st>>>(src, dst, items, c, seed); break;
    default: stream_kernel<MODE, 4><<<blocks, threads, 0, st>>>(src, dst, items, c, seed);
  }
}

template <bool WIDE>
void launch_pair_vec(int vec, const float4* src, float4* dst, int64_t items, const PairArgs& a,
                     const float2* row, const float2* lane, unsigned int blocks, int threads,
                     cudaStream_t st) {
  switch (vec) {
    case 1: pair_kernel<1, WIDE><<<blocks, threads, 0, st>>>(src, dst, items, a, row, lane); break;
    case 2: pair_kernel<2, WIDE><<<blocks, threads, 0, st>>>(src, dst, items, a, row, lane); break;
    default: pair_kernel<4, WIDE><<<blocks, threads, 0, st>>>(src, dst, items, a, row, lane);
  }
}

}  // namespace

// mode: 1 phase, 3 write (copy and read: qk_probe_copy, qk_probe_read).
// src, dst: device float2[2^n] (dst may equal src for phase; src is unused
// for write); c: host float2, the phase (phase only); seed: device float[1]
// (write only). threads: a multiple of 32 up to 1024; vec: 1, 2 or 4
// float4s per thread and step.
extern "C" int qk_probe_stream(int mode, const void* src, void* dst, int64_t n, const void* c,
                               const void* seed, int threads, int vec, int device,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n < 1 || n > 40 || (mode != kPhase && mode != kWrite) ||
      !geometry_ok(threads, vec, kMaxThreads))
    return (int)cudaErrorInvalidValue;
  const int64_t items = (int64_t(1) << n) / 2;  // float4s
  const unsigned int blocks = blocks_for(items, threads, vec);
  const float4* s = static_cast<const float4*>(src);
  float4* d = static_cast<float4*>(dst);
  const float2 ph = c ? *static_cast<const float2*>(c) : make_float2(1.f, 0.f);
  const float* sd = static_cast<const float*>(seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kPhase) {
    if (!c) return (int)cudaErrorInvalidValue;
    launch_stream_vec<kPhase>(vec, s, d, items, ph, sd, blocks, threads, st);
  } else {
    if (!sd) return (int)cudaErrorInvalidValue;
    launch_stream_vec<kWrite>(vec, s, d, items, ph, sd, blocks, threads, st);
  }
  return (int)cudaGetLastError();
}

// src, dst: device float2[2^n] (dst may equal src); q: the qubit, bit
// n-1-q; coef: host float2[5] = a, b, c, d, pc; row: device float2[tail >>
// cbits] or null; lane: device float2[2^cbits] or null, with 2^cbits <=
// tail = 2^(n-1-q). threads: a multiple of 32 up to 512; vec: 1, 2 or 4
// items per thread and step.
extern "C" int qk_probe_pair(const void* src, void* dst, int64_t n, int q, const void* coef,
                             const void* row, const void* lane, int cbits, int threads, int vec,
                             int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n < 1 || n > 40 || q < 0 || q >= n || cbits < 0 || cbits > n - 1 - q || !coef ||
      !geometry_ok(threads, vec, kPairMaxThreads))
    return (int)cudaErrorInvalidValue;
  const float2* cf = static_cast<const float2*>(coef);
  PairArgs a;
  a.a = cf[0];
  a.b = cf[1];
  a.c = cf[2];
  a.d = cf[3];
  a.pc = cf[4];
  a.sbits = int(n - 1 - q);
  a.cbits = cbits;
  const bool wide = a.sbits >= 1;
  const int64_t items = (int64_t(1) << n) / (wide ? 4 : 2);
  const unsigned int blocks = blocks_for(items, threads, vec);
  const float4* s = static_cast<const float4*>(src);
  float4* d = static_cast<float4*>(dst);
  const float2* r = static_cast<const float2*>(row);
  const float2* l = static_cast<const float2*>(lane);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide)
    launch_pair_vec<true>(vec, s, d, items, a, r, l, blocks, threads, st);
  else
    launch_pair_vec<false>(vec, s, d, items, a, r, l, blocks, threads, st);
  return (int)cudaGetLastError();
}
