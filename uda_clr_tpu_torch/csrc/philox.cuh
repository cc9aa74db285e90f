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

}  // namespace uda
