// Fused dropout for Hopper (sm_90a), forward and backward (K3).
//
// Replaces the TPU kernel uda_clr_tpu/ops/pallas/dropout.py:_dropout_kernel
// (launched by _apply, custom VJP dropout_pallas): random bits, mask and
// scale in one pass over x, so device memory sees one read of x and one write
// of y. Per element, with e its offset in memory:
//
//   y[e] = bits(e) < threshold ? round_T(x[e] * inv_keep) : 0
//
// inv_keep is 1/keep rounded to T (as the TPU kernel scales by
// jnp.asarray(1/keep, x.dtype)); threshold = floor(keep * 2^32). bits(e) is
// word (e & 3) of Philox4x32-10 at counter e >> 2 under the 64-bit seed
// (philox.cuh), so the plain version (ops/dropout.py:dropout_plain) replays
// it. The backward is the same launch on the cotangent with the same seed:
// the mask is regenerated, never stored.
//
// Bound: bytes. bf16 reads and writes 2 B per element (4 B in all); at the
// four dropout sites of the S||T forward at 512^2, B 8+8, that is ~874 MB,
// ~0.26 ms at 3.35 TB/s. Design: each thread takes a group of 4 consecutive
// elements, so one Philox call (10 rounds) serves 4 elements and its four
// words map one-to-one onto them; one 8-byte (bf16) or 16-byte (float32)
// load and store per group; a grid-stride loop over groups with no
// divisibility assumption (the last, partial group goes element by element).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Io4;

template <>
struct Io4<float> {
  static __device__ __forceinline__ void load(const float* p, float v[4]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store1(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float scale(float x, float s) { return __fmul_rn(x, s); }
};

template <>
struct Io4<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float v[4]) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float v[4]) {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  // the product of two bf16 values is exact in float; the store rounds once
  static __device__ __forceinline__ float scale(float x, float s) { return __fmul_rn(x, s); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n, uint64_t seed,
               uint32_t threshold, float inv_keep) {
  const uint2 key = uda::philox_key(seed);
  const int64_t groups = (n + 3) >> 2;
  for (int64_t g = int64_t(blockIdx.x) * kThreads + threadIdx.x; g < groups;
       g += int64_t(gridDim.x) * kThreads) {
    const uint4 r = uda::philox_group(uint64_t(g), key);
    const int64_t e0 = g << 2;
    if (e0 + 4 <= n) {
      float v[4];
      Io4<T>::load(x + e0, v);
      v[0] = r.x < threshold ? Io4<T>::scale(v[0], inv_keep) : 0.f;
      v[1] = r.y < threshold ? Io4<T>::scale(v[1], inv_keep) : 0.f;
      v[2] = r.z < threshold ? Io4<T>::scale(v[2], inv_keep) : 0.f;
      v[3] = r.w < threshold ? Io4<T>::scale(v[3], inv_keep) : 0.f;
      Io4<T>::store(y + e0, v);
    } else {
      for (int j = 0; e0 + j < n; ++j) {
        const float v = Io4<T>::load1(x + e0 + j);
        Io4<T>::store1(y + e0 + j,
                       uda::philox_word(r, j) < threshold ? Io4<T>::scale(v, inv_keep) : 0.f);
      }
    }
  }
}

}  // namespace

// y = dropout(x) over n elements in memory order. x and y must be aligned
// to 4 elements (8 bytes for bf16, 16 for float32); the wrapper checks.
// Launches on `stream` of card `device` and returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int uda_dropout(const void* x, void* y, long long n, unsigned long long seed,
                           unsigned int threshold, float inv_keep, int is_bf16, int device,
                           void* stream) {
  if (n <= 0) return 0;
  int sms = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  const long long blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const int grid = int(blocks < 16LL * sms ? blocks : 16LL * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    dropout_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n, seed, threshold,
        inv_keep);
  else
    dropout_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                   static_cast<float*>(y), n, seed, threshold,
                                                   inv_keep);
  return int(cudaGetLastError());
}
