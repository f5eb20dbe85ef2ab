// K3: a dense gate on the lowest min(n, 7) qubits, expanded to an L x L
// complex matrix U (L = 2^min(n,7)): out[r, :] = x[r, :] . U^T for every
// row r of L consecutive amplitudes, in place.
//
// Replaces: qubism_tpu/ops/kernels.py::_lane_gate_fn (entries
// lane_gate_prepare / lane_gate), which ran the product as four real
// 128-wide matmuls on the MXU at Precision.HIGHEST.
//
// Bound: operations. 128 complex multiply-adds per amplitude are 1024
// operations per 16 B read and written, far above the card's balance
// point, so the product belongs on the tensor cores. Their fastest type
// that can carry fp32 data is TF32 (10 mantissa bits); one TF32 product
// drifts ~3e-4 from the reference, so every operand is split into a TF32
// "big" part and a TF32 residual and three products are summed
// (small.big + big.small + big.big; small.small is below fp32 round-off).
// The bound is 3 x the operations over the TF32 peak.
//
// Design, L = 128 (lane_wgmma_kernel):
//  * A row of 128 complex64 is 256 floats (re, im, ...), and the pass is the
//    real product X (M x 256) . W (256 x 256), W built from Ur, Ui. It runs as
//    wgmma.m64n64k8 (tf32 in, fp32 out): the rows of the state are the A
//    operand, in registers; U is the B operand, in shared memory. The K and N
//    orders are chosen so that no operand is ever de-interleaved: in one k8
//    step slot t holds the real and slot t + 4 the imaginary part of complex
//    column i, so a thread's A fragment is the complex values it loaded, and
//    the same B tile (Ur[j][i] in slots 0-3, Ui[j][i] in slots 4-7) feeds two
//    accumulators: the real parts of 64 outputs with A = (re, -im), the
//    imaginary parts with A = (im, re). A thread so ends with (re, im, re,
//    im) of two neighbouring outputs: one 16-byte store.
//  * wgmma reads B from shared memory only, so both TF32 parts of U must
//    sit there: 2 x 128 KB, more than a block can have. A cluster of two
//    blocks therefore shares every tile of 128 rows: block h of the pair
//    holds the parts of outputs 64 h .. 64 h + 63 (128 KB, split on the
//    host, in the 8 x 16-byte core matrices the instruction reads: no
//    swizzle, K-major) and writes those outputs. Both blocks read the whole
//    tile (the second read hits L2), and a cluster barrier stands between
//    the pair's last read of a tile and its first write: the update stays
//    in place. Nothing of U is streamed or re-split on the device.
//  * A block is two warpgroups of 64 rows each. A thread reads its rows'
//    values straight from device memory into registers (16 B at a time,
//    prefetched one chunk ahead, across tiles too), forms big and small parts
//    there (integer round-to-nearest on the bit pattern, one subtraction) and
//    keeps them untouched until the chunk's wgmmas have been waited for.
//    While one warpgroup waits and adds, the other's wgmmas keep the tensor
//    cores busy.
//  * The tensor core adds into its accumulator with truncation; over the 32
//    big products of a full K loop that bias reaches ~2e-6. So each chunk of
//    four k8 steps runs its 3 x 4 products per accumulator from zero, small
//    terms first, and the result is added to the running sum by an fp32 add
//    (round to nearest): ~1.4e-7 from the float64 product.
//
// L < 128 (n < 7, at most 64 amplitudes): lane_small_kernel, plain fp32
// multiply-adds with U^T in shared memory.
#include "common.cuh"

namespace {

constexpr int kRowFloats = 256;        // one row of 128 complex64
constexpr int kThreads = 256;          // two warpgroups, 64 rows of the tile each
constexpr int kTileRows = 128;
constexpr int kPartFloats = 32 * 512;  // one TF32 part: [k8 step][ng][Ur, Ui][8][4]
constexpr int kStepBytes = 2048;       // one k8 step of one part
constexpr int kCoreBytes = 128;        // Ur's and Ui's core matrix lie this far apart,
constexpr int kGroupBytes = 256;       // neighbouring groups of 8 outputs this far
constexpr int kChunk = 4;              // k8 steps summed in the tensor core
constexpr int kSmemBytes = 2 * kPartFloats * sizeof(float);

// x = big + small with big on the TF32 grid (round to nearest on the bit
// pattern); the tensor core reads the top 19 bits of small.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// registers written by ordinary instructions may now be read by wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n"
               "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += a . b: a (64 x 8; a warp's 16 rows in the registers of its threads, laid
// out as for mma.m16n8k8), b (8 x 64) in shared memory behind `desc`
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc));
}

// after the wait: the accumulators hold what the tensor core wrote, and no
// ordinary instruction that reads them may move above this point
__device__ __forceinline__ void settle(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One k8 step's A operands from the complex values of rows g and g + 8: the
// real parts, the imaginary parts and their negatives, as big and small parts.
struct KFrag {
  uint32_t rb[2], ib[2], nb[2], rs[2], is[2], ns[2];
};

__device__ __forceinline__ void make_kfrag(KFrag& f, float re0, float im0, float re1, float im1) {
  const uint32_t sign = 0x80000000u;
  split_tf32(re0, f.rb[0], f.rs[0]);
  split_tf32(re1, f.rb[1], f.rs[1]);
  split_tf32(im0, f.ib[0], f.is[0]);
  split_tf32(im1, f.ib[1], f.is[1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    f.nb[r] = f.ib[r] ^ sign;
    f.ns[r] = f.is[r] ^ sign;
  }
}

// the registers of f stay as they are up to this point (wgmma reads them
// until it has been waited for)
__device__ __forceinline__ void hold(const KFrag& f) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
    asm volatile("" ::"r"(f.rb[r]), "r"(f.ib[r]), "r"(f.nb[r]), "r"(f.rs[r]), "r"(f.is[r]),
                 "r"(f.ns[r]));
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
lane_wgmma_kernel(float* __restrict__ s, int64_t rows, const float4* __restrict__ parts) {
  extern __shared__ __align__(128) float4 bsm[];  // [big, small][k8 step][ng][Ur, Ui][8]
  const uint32_t half = cluster_rank();
  const float4* src = parts + half * (2 * kPartFloats / 4);
  for (int i = threadIdx.x; i < 2 * kPartFloats / 4; i += kThreads) bsm[i] = src[i];
  // wgmma reads shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  // the matrix descriptor of the big part's first k8 step: address, the two
  // byte offsets (each >> 4), no swizzle
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(bsm);
  const uint64_t desc0 = uint64_t((sbase & 0x3ffffu) >> 4) | (uint64_t(kCoreBytes >> 4) << 16) |
                         (uint64_t(kGroupBytes >> 4) << 32);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rowin = (threadIdx.x >> 5) * 16 + g;
  const int64_t tiles = (rows + kTileRows - 1) / kTileRows;
  const int64_t pairs = gridDim.x >> 1;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // the float4s of k16 steps 2 chunk and 2 chunk + 1 in rows g and g + 8
  auto fetch = [&](int64_t tl, int chunk, float4(&a)[2], float4(&b)[2]) {
    const int64_t r0 = tl * kTileRows + rowin;
    const float4* p = reinterpret_cast<const float4*>(s + r0 * kRowFloats) + 8 * chunk + t;
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      a[sl] = r0 < rows ? p[4 * sl] : zero;
      b[sl] = r0 + 8 < rows ? p[4 * sl + 8 * kRowFloats / 4] : zero;
    }
  };

  // every thread of the pair runs the same number of tiles (the barrier)
  int64_t tile = blockIdx.x >> 1;
  float4 pa[2], pb[2];
  fetch(tile, 0, pa, pb);
  for (; tile < tiles; tile += pairs) {
    float run_re[32], run_im[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) run_re[i] = run_im[i] = 0.f;
#pragma unroll 1
    for (int c = 0; c < 32 / kChunk; ++c) {
      float4 xa[2], xb[2];
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        xa[sl] = pa[sl];
        xb[sl] = pb[sl];
      }
      if (c + 1 < 32 / kChunk) {
        fetch(tile, c + 1, pa, pb);
      } else if (tile + pairs < tiles) {
        fetch(tile + pairs, 0, pa, pb);
      }
      KFrag f[kChunk];  // k8 step 2 sl + h: complex columns 8 (2 c + sl) + 2 t + h
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        make_kfrag(f[2 * sl], xa[sl].x, xa[sl].y, xb[sl].x, xb[sl].y);
        make_kfrag(f[2 * sl + 1], xa[sl].z, xa[sl].w, xb[sl].z, xb[sl].w);
      }
      float t_re[32], t_im[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) t_re[i] = t_im[i] = 0.f;
      const uint64_t db = desc0 + uint64_t((c * kChunk * kStepBytes) >> 4);
      const uint64_t ds = db + uint64_t((kPartFloats * sizeof(float)) >> 4);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {  // small . big
        const uint64_t d = db + uint64_t((k * kStepBytes) >> 4);
        wgmma_n64(t_re, f[k].rs[0], f[k].rs[1], f[k].ns[0], f[k].ns[1], d);
        wgmma_n64(t_im, f[k].is[0], f[k].is[1], f[k].rs[0], f[k].rs[1], d);
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {  // big . small
        const uint64_t d = ds + uint64_t((k * kStepBytes) >> 4);
        wgmma_n64(t_re, f[k].rb[0], f[k].rb[1], f[k].nb[0], f[k].nb[1], d);
        wgmma_n64(t_im, f[k].ib[0], f[k].ib[1], f[k].rb[0], f[k].rb[1], d);
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {  // big . big
        const uint64_t d = db + uint64_t((k * kStepBytes) >> 4);
        wgmma_n64(t_re, f[k].rb[0], f[k].rb[1], f[k].nb[0], f[k].nb[1], d);
        wgmma_n64(t_im, f[k].ib[0], f[k].ib[1], f[k].rb[0], f[k].rb[1], d);
      }
      wgmma_commit_wait();
#pragma unroll
      for (int k = 0; k < kChunk; ++k) hold(f[k]);
      settle(t_re);
      settle(t_im);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        run_re[i] += t_re[i];
        run_im[i] += t_im[i];
      }
    }
    // both blocks of the pair have read the tile's rows: now they may be written
    cluster_sync();
    // an accumulator's c0, c1 are outputs 2 t, 2 t + 1 of row g; c2, c3 of row g + 8
    const int64_t r0 = tile * kTileRows + rowin;
    float4* o = reinterpret_cast<float4*>(s + r0 * kRowFloats) + 32 * half + t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* re = run_re + 4 * nt;
      const float* im = run_im + 4 * nt;
      if (r0 < rows) o[4 * nt] = make_float4(re[0], im[0], re[1], im[1]);
      if (r0 + 8 < rows) o[4 * nt + 8 * kRowFloats / 4] = make_float4(re[2], im[2], re[3], im[3]);
    }
  }
}

constexpr int kSmallThreads = 64;

// L <= 64: one thread per output column j of a row, U^T in shared memory.
__global__ void __launch_bounds__(kSmallThreads)
lane_small_kernel(float2* __restrict__ s, int L, const float2* __restrict__ ut) {
  __shared__ float2 u[64 * 64];  // u[i * L + j] = U[j][i]
  __shared__ float2 x[64];
  for (int i = threadIdx.x; i < L * L; i += blockDim.x) u[i] = ut[i];
  if (threadIdx.x < L) x[threadIdx.x] = s[threadIdx.x];
  __syncthreads();
  if (threadIdx.x >= L) return;
  float2 acc = make_float2(0.f, 0.f);
  for (int i = 0; i < L; ++i) acc = qk::cfma(u[i * L + threadIdx.x], x[i], acc);
  s[threadIdx.x] = acc;
}

}  // namespace

// state: device float2[2^n], 16-byte aligned. u: for n >= 7 device
// float[2][2][32][8][2][8][4], the TF32 parts of U in the order of the header
// ([output half][big, small][k8 step 2 s + c][ng][Ur, Ui][r][cc] is the part
// of U[64 half + 8 ng + r][8 s + 2 cc + c]); for n < 7 device float2[L][L]
// holding U transposed.
extern "C" int qk_lane(void* state, int64_t n, const void* u, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 7) {  // one row: the whole state
    lane_small_kernel<<<1, kSmallThreads, 0, st>>>(static_cast<float2*>(state), 1 << n,
                                                  static_cast<const float2*>(u));
    return (int)cudaGetLastError();
  }
  e = cudaFuncSetAttribute(lane_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int64_t rows = (int64_t(1) << n) / 128;
  const int64_t tiles = (rows + kTileRows - 1) / kTileRows;
  const int64_t fit = sms / 2 < 1 ? 1 : sms / 2;  // one block per SM
  const unsigned int pairs = (unsigned int)(tiles < fit ? tiles : fit);
  lane_wgmma_kernel<<<2 * pairs, kThreads, kSmemBytes, st>>>(static_cast<float*>(state), rows,
                                                             static_cast<const float4*>(u));
  return (int)cudaGetLastError();
}
