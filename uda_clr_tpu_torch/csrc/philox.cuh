// Philox4x32-10 (Salmon et al., SC'11; Random123's constants), shared by the
// port's kernels that draw dropout masks. Element e of a draw takes word
// (e & 3) of Philox at counter (e >> 2, 0, 0, 0) under the 64-bit key `seed`;
// the plain PyTorch versions (ops/mask_head.py:philox4x32_10) replay exactly
// this stream, so kernel and plain version agree elementwise.
#pragma once

#include <stdint.h>

namespace uda {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint2 philox_key(uint64_t seed) {
  return make_uint2(uint32_t(seed), uint32_t(seed >> 32));
}

// The four words of counter g (elements 4g .. 4g+3).
__device__ __forceinline__ uint4 philox_group(uint64_t g, uint2 key) {
  return philox4x32_10(make_uint4(uint32_t(g), uint32_t(g >> 32), 0u, 0u), key);
}

__device__ __forceinline__ uint32_t philox_word(uint4 r, int j) {
  return j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
}

// (hi, lo) words of a * b as one 32x32 -> 64 multiply (IMAD.WIDE.U32: ptxas
// fuses a separate high and low multiply into it anyway).
__device__ __forceinline__ void mul_wide(uint32_t a, uint32_t b, uint32_t& hi, uint32_t& lo) {
  asm("{\n"
      ".reg .u64 p;\n"
      "mul.wide.u32 p, %2, %3;\n"
      "mov.b64 {%1, %0}, p;\n"
      "}\n"
      : "=r"(hi), "=r"(lo)
      : "r"(a), "r"(b));
}

// The ten round keys of `seed`, computed once by a thread that draws many
// groups (registers instead of two key adds per round), and the product
// 0xD2511F53 * x[0] that round 1 multiplies when the counter's high word is 0.
struct PhiloxKeys {
  uint32_t x[10], y[10];
  uint32_t x0_hi, x0_lo;
};

__device__ __forceinline__ PhiloxKeys philox_keys(uint64_t seed) {
  PhiloxKeys k;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    k.x[i] = uint32_t(seed) + uint32_t(i) * 0x9E3779B9u;
    k.y[i] = uint32_t(seed >> 32) + uint32_t(i) * 0xBB67AE85u;
  }
  mul_wide(0xD2511F53u, k.x[0], k.x0_hi, k.x0_lo);
  return k;
}

// philox_group(g, key) with the round keys given: a round is two wide
// multiplies and two three-input xors.
__device__ __forceinline__ uint4 philox_group(uint64_t g, const PhiloxKeys& k) {
  uint32_t c0 = uint32_t(g), c1 = uint32_t(g >> 32), c2 = 0u, c3 = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    uint32_t hi0, lo0, hi1, lo1;
    mul_wide(0xD2511F53u, c0, hi0, lo0);
    mul_wide(0xCD9E8D57u, c2, hi1, lo1);
    c0 = hi1 ^ c1 ^ k.x[i];
    c2 = hi0 ^ c3 ^ k.y[i];
    c1 = lo1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// philox_group(g, k) for g < 2^32. With c1 = c2 = c3 = 0, round 0 leaves
// c0 = k.x[0], so round 1's first product is the key's, computed once: 18
// wide multiplies instead of 19 (the multiplies bound the draws).
__device__ __forceinline__ uint4 philox_group32(uint32_t g, const PhiloxKeys& k) {
  uint32_t hi, lo;
  mul_wide(0xD2511F53u, g, hi, lo);  // round 0
  uint32_t c2 = hi ^ k.y[0], c3 = lo;
  mul_wide(0xCD9E8D57u, c2, hi, lo);  // round 1
  uint32_t c0 = hi ^ k.x[1], c1 = lo;
  c2 = k.x0_hi ^ c3 ^ k.y[1];
  c3 = k.x0_lo;
#pragma unroll
  for (int i = 2; i < 10; ++i) {
    uint32_t hi0, lo0, hi1, lo1;
    mul_wide(0xD2511F53u, c0, hi0, lo0);
    mul_wide(0xCD9E8D57u, c2, hi1, lo1);
    c0 = hi1 ^ c1 ^ k.x[i];
    c2 = hi0 ^ c3 ^ k.y[i];
    c1 = lo1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

}  // namespace uda
