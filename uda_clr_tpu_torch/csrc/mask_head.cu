// Fused MC mask-head epilogue for Hopper (sm_90a), two entry points:
//
// * uda_mask_head_split (K1) replaces the TPU kernel
//   uda_clr_tpu/ops/pallas/mask_head.py:_kernel_split (launched by
//   _fused_split, entry fused_mask_head_split): the 305 input channels arrive
//   as three row-major views that are never concatenated, x_up [M,256],
//   ll [M,48], boundary [M,1];
// * uda_mask_head (K2) replaces mask_head.py:_kernel (launched by _fused,
//   entry fused_mask_head): x_bu [M,304] and boundary [M,1].
//
// Both run the same row code: K2 reads channels 0-255 and 256-303 of x_bu
// through the two views K1 takes, with x_bu's row stride. Semantics are those
// of the plain version, _xla_reference (mask_head.py:134-151). Per row:
//
//   h   = relu((x - mu) * a + beta)            each op rounded to T
//   h   = bits < threshold ? h * inv_keep : 0  (dropout, rounded to T)
//   out = sum_c h[c] * W[c, :] + bias          (float32 sums, rounded to T)
//
// a = rsqrt(var + eps) * scale, mu, beta and W are precomputed by the wrapper
// (already rounded to T, stored as float32) and staged in shared memory;
// inv_keep is 1/keep rounded to T, as the TPU kernels scale.
// bits is word (e & 3) of Philox4x32-10 at counter (e >> 2, 0), key = seed,
// for the element index e = row * 305 + channel; the wrapper's plain
// version replays the same stream.
//
// Bound: bytes. At the flagship shape (M = 64*128*128 rows, bf16) it reads
// 305*2 B and writes 4 B per row, ~640 MB (~0.19 ms at 3.35 TB/s), against
// ~2.6 GFLOP of float work. The integer work of the Philox draws (2-3 calls
// per 8 elements, 10 rounds each) is what this first version may spend most
// of its time on. Design: one warp per row; lane L loads channels 8L..8L+7 of
// x_up with one 16-byte load (bf16), lanes 0-5 take the 48 ll channels the
// same way, lane 6 the boundary channel, so every input byte is read once in
// coalesced 512-byte row segments; the two sums are reduced with
// __shfl_xor_sync. A persistent grid walks the rows, so the coefficients are
// staged once per block, in a bank-conflict-free layout. No tensor-core
// work: N = 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kCx = 256;
constexpr int kCl = 48;
constexpr int kC = 305;
constexpr int kWarps = 8;  // rows in flight per block

// Random words of the 8 consecutive elements e0 .. e0+7.
__device__ __forceinline__ void bits8(uint64_t e0, uint2 key, uint32_t out[8]) {
  const uint64_t g0 = e0 >> 2;
  const int off = int(e0 & 3);
  const uint4 r0 = uda::philox_group(g0, key);
  const uint4 r1 = uda::philox_group(g0 + 1, key);
  const uint4 r2 = off ? uda::philox_group(g0 + 2, key) : r0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = off + i;  // 0 .. 10
    const uint4 r = idx < 4 ? r0 : idx < 8 ? r1 : r2;
    out[i] = uda::philox_word(r, idx & 3);
  }
}

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load8(const float* p, float v[8]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// One element: coefficient k of its channel is p[k * stride] (mu, a, beta,
// W[c,0], W[c,1]). Explicit _rn intrinsics: no FMA contraction, so each op
// rounds where the plain version's does.
template <typename T, bool kDrop>
__device__ __forceinline__ void accumulate(float x, const float* p, int stride, uint32_t bits,
                                           uint32_t threshold, float inv_keep, float& acc0,
                                           float& acc1) {
  float h = Io<T>::round(__fsub_rn(x, p[0]));
  h = Io<T>::round(__fmul_rn(h, p[stride]));
  h = Io<T>::round(__fadd_rn(h, p[2 * stride]));
  h = fmaxf(h, 0.f);
  if (kDrop) h = bits < threshold ? Io<T>::round(__fmul_rn(h, inv_keep)) : 0.f;
  acc0 = __fadd_rn(acc0, __fmul_rn(h, p[3 * stride]));
  acc1 = __fadd_rn(acc1, __fmul_rn(h, p[4 * stride]));
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
mask_head_split_kernel(const T* __restrict__ x, const T* __restrict__ ll,
                       const T* __restrict__ bnd, const float* __restrict__ coef,
                       T* __restrict__ out, int64_t m, int64_t x_stride, int64_t ll_stride,
                       uint64_t seed, uint32_t threshold, float inv_keep) {
  // x_stride / ll_stride: elements between rows of the x (channels 0-255)
  // and ll (channels 256-303) views; 256 / 48 for K1, 304 / 304 for K2.
  // coef is [5, 305] (mu | a | beta | W[:,0] | W[:,1]) then bias[2]. Lane L
  // always owns channels 8L..8L+7 of x (and of ll for L < 6), so each part
  // is staged as [k][i][lane]: the 32 lanes' reads of element i hit 32
  // distinct banks.
  __shared__ float sx[5][8][32];
  __shared__ float sl[5][8][kCl / 8];
  __shared__ float sb[5 + 2];  // the boundary channel's five, then bias[2]
  for (int j = threadIdx.x; j < 5 * kCx; j += blockDim.x) {
    const int k = j / kCx, l = j % 32, i = (j % kCx) / 32;
    sx[k][i][l] = coef[k * kC + l * 8 + i];
  }
  for (int j = threadIdx.x; j < 5 * kCl; j += blockDim.x) {
    const int k = j / kCl, l = j % (kCl / 8), i = (j % kCl) / (kCl / 8);
    sl[k][i][l] = coef[k * kC + kCx + l * 8 + i];
  }
  if (threadIdx.x < 5) sb[threadIdx.x] = coef[threadIdx.x * kC + kC - 1];
  if (threadIdx.x < 2) sb[5 + threadIdx.x] = coef[5 * kC + threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const uint2 key = uda::philox_key(seed);
  uint32_t bits[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  float v[8];

  for (int64_t row = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5); row < m;
       row += int64_t(gridDim.x) * kWarps) {
    const uint64_t e_row = uint64_t(row) * kC;
    float acc0 = 0.f, acc1 = 0.f;

    Io<T>::load8(x + row * x_stride + lane * 8, v);
    if (kDrop) bits8(e_row + lane * 8, key, bits);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      accumulate<T, kDrop>(v[i], &sx[0][i][lane], 8 * 32, bits[i], threshold, inv_keep,
                           acc0, acc1);

    if (lane < kCl / 8) {
      Io<T>::load8(ll + row * ll_stride + lane * 8, v);
      if (kDrop) bits8(e_row + kCx + lane * 8, key, bits);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        accumulate<T, kDrop>(v[i], &sl[0][i][lane], kCl, bits[i], threshold, inv_keep,
                             acc0, acc1);
    } else if (lane == kCl / 8) {
      const uint64_t e = e_row + kC - 1;
      const uint32_t b = kDrop ? uda::philox_word(uda::philox_group(e >> 2, key), int(e & 3)) : 0u;
      accumulate<T, kDrop>(Io<T>::load1(bnd + row), sb, 1, b, threshold, inv_keep, acc0,
                           acc1);
    }

#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc0 += __shfl_xor_sync(0xffffffffu, acc0, o);
      acc1 += __shfl_xor_sync(0xffffffffu, acc1, o);
    }
    if (lane == 0) Io<T>::store2(out + row * 2, acc0 + sb[5], acc1 + sb[6]);
  }
}

template <typename T>
void launch(const void* x, const void* ll, const void* bnd, const float* coef, void* out,
            int64_t m, int64_t x_stride, int64_t ll_stride, uint64_t seed, uint32_t threshold,
            float inv_keep, bool drop, int grid, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* lt = static_cast<const T*>(ll);
  const T* bt = static_cast<const T*>(bnd);
  T* ot = static_cast<T*>(out);
  if (drop)
    mask_head_split_kernel<T, true><<<grid, kWarps * 32, 0, stream>>>(
        xt, lt, bt, coef, ot, m, x_stride, ll_stride, seed, threshold, inv_keep);
  else
    mask_head_split_kernel<T, false><<<grid, kWarps * 32, 0, stream>>>(
        xt, lt, bt, coef, ot, m, x_stride, ll_stride, seed, threshold, inv_keep);
}

int run(const void* x, const void* ll, const void* bnd, const void* coef, void* out, long long m,
        long long x_stride, long long ll_stride, unsigned long long seed, unsigned int threshold,
        float inv_keep, int drop, int is_bf16, int device, void* stream) {
  if (m <= 0) return 0;
  int sms = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  const long long needed = (m + kWarps - 1) / kWarps;
  const int grid = int(needed < 8LL * sms ? needed : 8LL * sms);
  const float* c = static_cast<const float*>(coef);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, ll, bnd, c, out, m, x_stride, ll_stride, seed, threshold, inv_keep,
                          drop != 0, grid, s);
  else
    launch<float>(x, ll, bnd, c, out, m, x_stride, ll_stride, seed, threshold, inv_keep,
                  drop != 0, grid, s);
  return int(cudaGetLastError());
}

}  // namespace

// Both entries launch on `stream` of card `device` (the caller's tensors'
// card: this library's runtime keeps its own current device) and return
// cudaGetLastError() after the launch (0 = launched).

// K1: x [m,256], ll [m,48], bnd [m,1] row-major.
extern "C" int uda_mask_head_split(const void* x, const void* ll, const void* bnd,
                                   const void* coef, void* out, long long m,
                                   unsigned long long seed, unsigned int threshold,
                                   float inv_keep, int drop, int is_bf16, int device,
                                   void* stream) {
  return run(x, ll, bnd, coef, out, m, kCx, kCl, seed, threshold, inv_keep, drop, is_bf16, device,
             stream);
}

// K2: x_bu [m,304], bnd [m,1] row-major; the element index of channel c of
// row r is r*305 + c, as in K1, so K2 on cat(x_up, ll) equals K1 bitwise.
extern "C" int uda_mask_head(const void* x_bu, const void* bnd, const void* coef, void* out,
                             long long m, unsigned long long seed, unsigned int threshold,
                             float inv_keep, int drop, int is_bf16, int device, void* stream) {
  const int64_t width = kCx + kCl;
  const void* ll = is_bf16 ? static_cast<const void*>(static_cast<const __nv_bfloat16*>(x_bu) + kCx)
                           : static_cast<const void*>(static_cast<const float*>(x_bu) + kCx);
  return run(x_bu, ll, bnd, coef, out, m, width, width, seed, threshold, inv_keep, drop, is_bf16,
             device, stream);
}
