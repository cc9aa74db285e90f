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
// Semantics are those of the plain version, _xla_reference
// (mask_head.py:134-151). Per row:
//
//   h   = relu((x - mu) * a + beta)            each op rounded to T
//   h   = bits < threshold ? h * inv_keep : 0  (dropout, rounded to T)
//   out = sum_c h[c] * W[c, :] + bias          (float32 sums, rounded to T)
//
// a = rsqrt(var + eps) * scale, mu, beta and W are precomputed by the wrapper
// (already rounded to T, stored as float32); inv_keep is 1/keep rounded to
// T, as the TPU kernels scale. bits is word (e & 3) of Philox4x32-10 at
// counter (e >> 2, 0), key = seed, for the element index e = row * 305 +
// channel; the wrapper's plain version replays the same stream. Both entries
// share every instruction, so K2 on cat(x_up, ll) equals K1 bitwise.
//
// Bound: bytes. At the flagship shape (M = 64*128*128 rows, bf16) it reads
// 305*2 B and writes 4 B per row, ~644 MB, 0.19 ms at 3.35 TB/s (f32: 0.38
// ms). Next comes the integer floor of the draws: 1,048,576 rows * 76.25
// Philox groups = 80 M Philox4x32-10 evaluations, ~40 integer instructions
// each once the round keys are hoisted: ~100 M warp instructions, ~0.1-0.2
// ms across 132 SMs by instruction count. Measured, the draws cost more:
// their 32x32 -> 64-bit multiplies (IMAD.WIDE.U32, 18 per group) issue at a
// fraction of the FP32 rate, and on an H100 at 700 W the draw alone takes
// ~0.32 ms (PERF.md). The float work is ~16 ops per element, 4 of them the
// two f32 multiply-adds of the 305 -> 2 product: N = 2 leaves nothing for
// the tensor cores, which this kernel does not use.
//
// Design: a persistent grid (two blocks of 256 threads per SM) walks tiles
// of kRows = 32 rows (19,520 B of inputs in bf16, 39,040 B in f32). A tile's
// elements are the contiguous index range [305*r0, 305*(r0 + 32)), and
// 305*r0 is a multiple of 4, so
//   1. draw: at a rate above 0, warps 4-7 evaluate each of the tile's 2,440
//      Philox groups once (round keys in registers; 18 wide multiplies and
//      20 three-input xors per group), compare the four words with the
//      threshold and store one word of keep bytes (0xFF kept, 0 dropped) per
//      group into shared memory: no shuffles, consecutive addresses. Two
//      mask buffers hand tiles to the compute warps through mbarriers, so
//      the draws' multiplies issue beside the compute's float and shared
//      memory work on every SM sub-partition. The rate-0 instance draws
//      nothing and computes with all eight warps;
//   2. copy: each input tile is one contiguous span per view, so one thread
//      stages it with 1-D bulk copies (cp.async.bulk, completion on an
//      mbarrier) into a ring of kStages stages (3 in bf16, 2 in f32), each
//      refilled as soon as its tile is computed; the tail of a ragged tile's
//      boundary span (not a multiple of 16 B) is read with plain loads;
//   3. compute: warps 0-3 (all eight at rate 0) take 8 (4) rows each, one
//      row at a time, from shared memory. Lane L takes the x channels of
//      16-byte chunk L (and L + 32 in f32) and the ll|boundary channels 256+L
//      and 288+L (L < 17), so every lane is busy and every shared read is
//      16 B (or 1-4 B) per lane at consecutive addresses. Its coefficients
//      live in registers for the whole run. Row k of a warp starts at mask
//      byte offset k & 3, known at compile time, so one byte permute turns a
//      pair's two keep bytes into its lane mask. In bf16 the affine, ReLU and
//      dropout run as packed __nv_bfloat162 ops in their _rn forms (no FMA
//      contraction): for +, -, * on bf16 operands, f32 rounding then bf16
//      rounding equals one bf16 rounding (24 >= 2*8 + 2), so the packed op
//      gives the plain version's bits. The sums use f32 fmaf; a warp's rows
//      are reduced together by a transposing butterfly (16 shuffles for 8
//      rows' two outputs instead of 80).
// Shared memory per block: 78,168 B in bf16, 97,680 B in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kCx = 256;
constexpr int kCl = 48;
constexpr int kC = 305;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr int kRows = 32;  // rows per tile: a multiple of 4, so 305 * r0 is one too
// the keep mask, one byte per element (0xFF kept, 0 dropped); 16 bytes of
// slack: lanes above 16 read the (unused) byte 32 elements past their ll
// channel
constexpr int kMaskBytes = (kRows * kC + 16 + 15) / 16 * 16;

template <typename T>
struct Tile {
  static_assert(sizeof(T) == 2 || sizeof(T) == 4, "bf16 or f32");
  static constexpr int kV = 16 / int(sizeof(T));   // elements per 16-byte chunk
  static constexpr int kChunks = kCx / (32 * kV);  // x chunks per lane: 1 or 2
  static constexpr int kPairs = kChunks * kV / 2;  // x element pairs per lane: 4
  static constexpr int kInBytes = kRows * (kCx + kCl) * int(sizeof(T));
  static constexpr int kStageBytes = kInBytes + (kRows * int(sizeof(T)) + 15) / 16 * 16;
  // bf16 keeps two tiles in flight beside the one computed on; f32's larger
  // stages leave room for one
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
  // stages, two masks, and the mbarriers: one per stage, two per mask
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kMaskBytes + (kStages + 4) * 8;
  static constexpr int kMinBlocks = 2;  // blocks per SM: 78,168 B (bf16) or 97,680 B each
};

// ---- mbarrier and bulk-copy PTX ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned; completes `bytes` transactions on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- the element math on pairs of channels ----

template <typename T>
struct Math;

template <>
struct Math<__nv_bfloat16> {
  using P = __nv_bfloat162;
  using Keep = uint32_t;  // the pair's keep mask: 0xFFFF per kept half
  static __device__ __forceinline__ P make(float a, float b) {
    return __floats2bfloat162_rn(a, b);  // exact: a and b are bf16 values
  }
  static __device__ __forceinline__ P affine(P x, P mu, P a, P beta) {
    const P h = __hadd2_rn(__hmul2_rn(__hsub2_rn(x, mu), a), beta);
    return __hmax2(h, __float2bfloat162_rn(0.f));  // fmaxf's rule: a NaN yields the other operand
  }
  // mask bytes s0 (.x) and s1 (.y) of the 8-byte window (a, b), each 0 or 0xFF
  static __device__ __forceinline__ Keep keep(uint32_t a, uint32_t b, int s0, int s1) {
    return __byte_perm(a, b, s0 | s0 << 4 | s1 << 8 | s1 << 12);
  }
  static __device__ __forceinline__ P drop(P h, P inv, Keep keep) {
    const P k = __hmul2_rn(h, inv);
    const uint32_t u = reinterpret_cast<const uint32_t&>(k) & keep;
    return reinterpret_cast<const P&>(u);
  }
  // a byte permute and an and (integer pipe), not two multiplies by 2^16
  // on the multiply pipe the Philox draws saturate
  static __device__ __forceinline__ float2 wide(P h) {
    const uint32_t u = reinterpret_cast<const uint32_t&>(h);
    return make_float2(__uint_as_float(__byte_perm(u, 0u, 0x1044)),
                       __uint_as_float(u & 0xFFFF0000u));
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ P pack(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __halves2bfloat162(a, b);
  }
};

template <>
struct Math<float> {
  using P = float2;
  using Keep = uint2;  // 0xFFFFFFFF per kept element
  static __device__ __forceinline__ P make(float a, float b) { return make_float2(a, b); }
  static __device__ __forceinline__ float one(float x, float mu, float a, float beta) {
    return fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(x, mu), a), beta), 0.f);
  }
  static __device__ __forceinline__ P affine(P x, P mu, P a, P beta) {
    return make_float2(one(x.x, mu.x, a.x, beta.x), one(x.y, mu.y, a.y, beta.y));
  }
  static __device__ __forceinline__ Keep keep(uint32_t a, uint32_t b, int s0, int s1) {
    return make_uint2(__byte_perm(a, b, s0 * 0x1111), __byte_perm(a, b, s1 * 0x1111));
  }
  static __device__ __forceinline__ P drop(P h, P inv, Keep keep) {
    return make_float2(__uint_as_float(__float_as_uint(__fmul_rn(h.x, inv.x)) & keep.x),
                       __uint_as_float(__float_as_uint(__fmul_rn(h.y, inv.y)) & keep.y));
  }
  static __device__ __forceinline__ float2 wide(P h) { return h; }
  static __device__ __forceinline__ float out(float v) { return v; }
  static __device__ __forceinline__ P pack(float a, float b) { return make_float2(a, b); }
};

// A lane's coefficients for one pair of channels.
template <typename T>
struct PairCoef {
  typename Math<T>::P mu, a, beta;
  float2 w0, w1;
};

// coef is [5, 305] (mu | a | beta | W[:,0] | W[:,1]) then bias[2]; a channel
// >= 305 gets zeros, which make its h and its terms 0 whatever it reads.
template <typename T>
__device__ __forceinline__ PairCoef<T> load_coef(const float* coef, int c0, int c1) {
  auto at = [&](int k, int c) { return c < kC ? __ldg(coef + k * kC + c) : 0.f; };
  PairCoef<T> p;
  p.mu = Math<T>::make(at(0, c0), at(0, c1));
  p.a = Math<T>::make(at(1, c0), at(1, c1));
  p.beta = Math<T>::make(at(2, c0), at(2, c1));
  p.w0 = make_float2(at(3, c0), at(3, c1));
  p.w1 = make_float2(at(4, c0), at(4, c1));
  return p;
}

template <typename T, bool kDrop>
__device__ __forceinline__ void accumulate(typename Math<T>::P x, const PairCoef<T>& c,
                                           typename Math<T>::P inv, typename Math<T>::Keep keep,
                                           float& acc0, float& acc1) {
  typename Math<T>::P h = Math<T>::affine(x, c.mu, c.a, c.beta);
  if (kDrop) h = Math<T>::drop(h, inv, keep);
  const float2 f = Math<T>::wide(h);
  acc0 = fmaf(f.y, c.w0.y, fmaf(f.x, c.w0.x, acc0));
  acc1 = fmaf(f.y, c.w1.y, fmaf(f.x, c.w1.x, acc1));
}

// Sum each of v[0..N) over the warp. After the call lane L holds the sum of
// value L / (32 / N) in v[0]: each step hands half of the values still held
// to the partner lane and keeps the sums of the other half.
template <int N, int S>
struct WarpSums {
  static __device__ __forceinline__ void run(float* v, int lane) {
    if constexpr (S == 0) {
      return;
    } else if constexpr (N > 1) {
      const bool upper = lane & S;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = upper ? v[i] : v[i + N / 2];
        const float keep = upper ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
      }
      WarpSums<N / 2, S / 2>::run(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], S);
      WarpSums<1, S / 2>::run(v, lane);
    }
  }
};

// One thread stages tile rows [r0, r0 + n) into `stage`.
template <typename T, bool kSplit>
__device__ __forceinline__ void issue_tile(char* stage, uint32_t bar, const T* x, const T* ll,
                                           const T* bnd, int64_t r0, int n) {
  using L = Tile<T>;
  const uint32_t dst = smem_addr(stage);
  const uint32_t in_bytes = uint32_t(n) * (kCx + kCl) * sizeof(T);
  const uint32_t bnd_bulk = (uint32_t(n) * sizeof(T)) & ~15u;
  bar_arrive_expect(bar, in_bytes + bnd_bulk);
  if (kSplit) {
    bulk_load(dst, x + r0 * kCx, uint32_t(n) * kCx * sizeof(T), bar);
    bulk_load(dst + kRows * kCx * sizeof(T), ll + r0 * kCl, uint32_t(n) * kCl * sizeof(T), bar);
  } else {
    bulk_load(dst, x + r0 * (kCx + kCl), in_bytes, bar);
  }
  if (bnd_bulk) bulk_load(dst + L::kInBytes, bnd + r0, bnd_bulk, bar);
  T* tail = reinterpret_cast<T*>(stage + L::kInBytes);
  for (int i = bnd_bulk / sizeof(T); i < n; ++i) tail[i] = bnd[r0 + i];
}

// Draw groups first, first + step, ... < `groups` of a tile's keep mask
// (global group g0 + g): byte j of word g is element 4 g + j's, 0xFF if kept.
__device__ __forceinline__ void draw_mask(uint32_t* mask, uint64_t g0, int groups,
                                          const uda::PhiloxKeys& keys, uint32_t threshold,
                                          int first, int step) {
  auto keep_bytes = [threshold](uint4 r) {
    return (r.x < threshold ? 0x000000FFu : 0u) | (r.y < threshold ? 0x0000FF00u : 0u) |
           (r.z < threshold ? 0x00FF0000u : 0u) | (r.w < threshold ? 0xFF000000u : 0u);
  };
  if (g0 + uint64_t(groups) <= (uint64_t(1) << 32)) {  // every counter's high word is 0
#pragma unroll 2
    for (int g = first; g < groups; g += step)
      mask[g] = keep_bytes(uda::philox_group32(uint32_t(g0) + uint32_t(g), keys));
  } else {
    for (int g = first; g < groups; g += step)
      mask[g] = keep_bytes(uda::philox_group(g0 + uint64_t(g), keys));
  }
}

template <typename T, bool kSplit, bool kDrop>
__global__ void __launch_bounds__(kThreads, Tile<T>::kMinBlocks)
mask_head_kernel(const T* __restrict__ x, const T* __restrict__ ll, const T* __restrict__ bnd,
                 const float* __restrict__ coef, T* __restrict__ out, int64_t m, uint64_t seed,
                 uint32_t threshold, float inv_keep) {
  using L = Tile<T>;
  using M = Math<T>;
  using P = typename M::P;
  constexpr int kStages = L::kStages;
  // with dropout, warps 0-3 compute and warps 4-7 draw the masks; at rate 0
  // all eight compute
  constexpr int kComputeWarps = kDrop ? kWarps / 2 : kWarps;
  constexpr int kComputeThreads = 32 * kComputeWarps;
  constexpr int kRpw = kRows / kComputeWarps;  // rows per compute warp: 8 or 4
  static_assert(kRpw % 4 == 0, "row * 305 & 3 is then known at compile time");
  // shared-memory rows: K1 stages x [R,256] then ll [R,48]; K2 x_bu [R,304]
  constexpr int kXs = kSplit ? kCx : kCx + kCl;
  constexpr int kLs = kSplit ? kCl : kCx + kCl;
  constexpr int kLoff = kSplit ? kRows * kCx : kCx;
  constexpr int kMaskWords = (L::kV + 2) / 4 + 1;  // words that bytes o .. o + kV - 1 may span

  extern __shared__ __align__(128) char smem[];
  char* masks = smem + kStages * L::kStageBytes;
  // mbarriers: full[kStages] (bytes of a stage's copies), mask_full[2] (the
  // draw warps' arrivals), mask_empty[2] (the compute warps' arrivals)
  const uint32_t full0 = smem_addr(masks + 2 * kMaskBytes);
  const uint32_t mask_full0 = full0 + 8 * kStages, mask_empty0 = mask_full0 + 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t tiles = (m + kRows - 1) / kRows;
  auto rows_of = [&](int64_t t) { return int(m - t * kRows < kRows ? m - t * kRows : kRows); };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(full0 + 8 * s, 1);
    for (int b = 0; kDrop && b < 2; ++b) {
      bar_init(mask_full0 + 8 * b, kThreads - kComputeThreads);
      bar_init(mask_empty0 + 8 * b, kComputeThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (kDrop && warp >= kComputeWarps) {
    // draw: mask buffer i & 1 holds the block's i-th tile, once the compute
    // warps have released it from tile i - 2
    const uda::PhiloxKeys keys = uda::philox_keys(seed);
    for (int i = 0; blockIdx.x + int64_t(i) * gridDim.x < tiles; ++i) {
      const int64_t t = blockIdx.x + int64_t(i) * gridDim.x;
      const int b = i & 1;
      if (i >= 2) bar_wait(mask_empty0 + 8 * b, uint32_t((i - 2) >> 1) & 1u);
      draw_mask(reinterpret_cast<uint32_t*>(masks + b * kMaskBytes), uint64_t(t) * kRows * kC / 4,
                (rows_of(t) * kC + 3) / 4, keys, threshold, tid - kComputeThreads,
                kThreads - kComputeThreads);
      bar_arrive(mask_full0 + 8 * b);
    }
    return;
  }

  if (tid == 0)
    for (int s = 0; s < kStages; ++s) {
      const int64_t t = blockIdx.x + int64_t(s) * gridDim.x;
      if (t < tiles)
        issue_tile<T, kSplit>(smem + s * L::kStageBytes, full0 + 8 * s, x, ll, bnd, t * kRows,
                              rows_of(t));
    }

  // this lane's channels: pair p of x chunk j is (32 j + lane) kV + 2 (p % (kV/2)) + {0, 1};
  // the ll|boundary pair is 256 + lane and 288 + lane (zero coefficients for lane > 16)
  PairCoef<T> cx[L::kPairs];
#pragma unroll
  for (int p = 0; p < L::kPairs; ++p) {
    const int c = (32 * (p / (L::kV / 2)) + lane) * L::kV + 2 * (p % (L::kV / 2));
    cx[p] = load_coef<T>(coef, c, c + 1);
  }
  const PairCoef<T> cl = load_coef<T>(coef, kCx + lane, kCx + 32 + lane);
  // element offsets in a stage of the pair's two values, and their row strides
  const int l0_off = kLoff + lane;
  const int l1_off = lane < 16 ? kLoff + 32 + lane : L::kInBytes / int(sizeof(T));
  const int l1_stride = lane < 16 ? kLs : 1;
  const float bias = __ldg(coef + 5 * kC + (lane / (32 / (2 * kRpw)) & 1));
  const P inv = M::make(inv_keep, inv_keep);

  // the block's i-th tile is in stage s, whose mbarrier is then in phase
  // (i / kStages) & 1
  int s = 0;
  uint32_t phase = 0;
  for (int i = 0; blockIdx.x + int64_t(i) * gridDim.x < tiles; ++i) {
    const int64_t t = blockIdx.x + int64_t(i) * gridDim.x;
    const int n = rows_of(t);
    const int64_t r0 = t * kRows;
    const char* mask = masks + (i & 1) * kMaskBytes;
    bar_wait(full0 + 8 * s, phase);
    if (kDrop) bar_wait(mask_full0 + 8 * (i & 1), uint32_t(i >> 1) & 1u);

    const T* st = reinterpret_cast<const T*>(smem + s * L::kStageBytes);
    float v[2 * kRpw];
#pragma unroll
    for (int k = 0; k < kRpw; ++k) {
      const int row = warp * kRpw + k;
      const int le = row * kC;
      const int o = (k * kC) & 3;  // le & 3, a constant once the loop is unrolled
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int j = 0; j < L::kChunks; ++j) {
        const int c = (32 * j + lane) * L::kV;
        const uint4 raw = *reinterpret_cast<const uint4*>(st + row * kXs + c);
        const P* pair = reinterpret_cast<const P*>(&raw);
        // the chunk's mask bytes are bytes o .. o + kV - 1 of words w
        uint32_t w[kMaskWords];
        if (kDrop) {
          const uint32_t* mw = reinterpret_cast<const uint32_t*>(mask + le + c - o);
#pragma unroll
          for (int q = 0; q < kMaskWords; ++q) w[q] = mw[q];
        }
#pragma unroll
        for (int q = 0; q < L::kV / 2; ++q) {
          const int fb = o + 2 * q;
          typename M::Keep keep{};
          if (kDrop)
            keep = M::keep(w[fb >> 2], (fb & 3) == 3 ? w[(fb >> 2) + 1] : w[fb >> 2], fb & 3,
                           (fb & 3) + 1);
          accumulate<T, kDrop>(pair[q], cx[j * (L::kV / 2) + q], inv, keep, acc0, acc1);
        }
      }
      // ll|boundary pair: channels 256 + lane and 288 + lane
      const P lpair = M::pack(st[l0_off + row * kLs], st[l1_off + row * l1_stride]);
      typename M::Keep keep{};
      if (kDrop) {
        const int e0 = le + kCx + lane;
        keep = M::keep(uint8_t(mask[e0]), uint8_t(mask[e0 + 32]), 0, 4);
      }
      accumulate<T, kDrop>(lpair, cl, inv, keep, acc0, acc1);
      v[2 * k] = acc0;
      v[2 * k + 1] = acc1;
    }
    if (kDrop) bar_arrive(mask_empty0 + 8 * (i & 1));
    WarpSums<2 * kRpw, 16>::run(v, lane);
    // lane holds value lane / (32 / N) = 2 k + o: row k of the warp, output o
    constexpr int kDup = 32 / (2 * kRpw);
    const int idx = lane / kDup;
    if (lane % kDup == 0 && warp * kRpw + (idx >> 1) < n)
      out[(r0 + warp * kRpw) * 2 + idx] = M::out(v[0] + bias);

    // every compute thread is done with this stage; this proxy read it, the
    // next copy writes it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kComputeThreads) : "memory");
    if (tid == 0) {
      const int64_t tc = t + int64_t(kStages) * gridDim.x;
      if (tc < tiles)
        issue_tile<T, kSplit>(smem + s * L::kStageBytes, full0 + 8 * s, x, ll, bnd, tc * kRows,
                              rows_of(tc));
    }
    if (++s == kStages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

template <typename T, bool kSplit, bool kDrop>
cudaError_t occupancy(int* blocks_per_sm) {
  auto kernel = mask_head_kernel<T, kSplit, kDrop>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<T>::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                        Tile<T>::kSmemBytes);
  return err;
}

template <typename T, bool kSplit, bool kDrop>
cudaError_t launch(const void* x, const void* ll, const void* bnd, const float* coef, void* out,
                   int64_t m, uint64_t seed, uint32_t threshold, float inv_keep, int sms,
                   cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = occupancy<T, kSplit, kDrop>(&per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (m + kRows - 1) / kRows;
  const int grid = int(tiles < int64_t(per_sm) * sms ? tiles : int64_t(per_sm) * sms);
  mask_head_kernel<T, kSplit, kDrop><<<grid, kThreads, Tile<T>::kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ll), static_cast<const T*>(bnd), coef,
      static_cast<T*>(out), m, seed, threshold, inv_keep);
  return cudaGetLastError();
}

template <typename T, bool kSplit>
cudaError_t launch(const void* x, const void* ll, const void* bnd, const float* coef, void* out,
                   int64_t m, uint64_t seed, uint32_t threshold, float inv_keep, bool drop,
                   int sms, cudaStream_t stream) {
  return drop ? launch<T, kSplit, true>(x, ll, bnd, coef, out, m, seed, threshold, inv_keep, sms,
                                        stream)
              : launch<T, kSplit, false>(x, ll, bnd, coef, out, m, seed, threshold, inv_keep,
                                         sms, stream);
}

int run(const void* x, const void* ll, const void* bnd, const void* coef, void* out, long long m,
        bool split, unsigned long long seed, unsigned int threshold, float inv_keep, int drop,
        int is_bf16, int device, void* stream) {
  if (m <= 0) return 0;
  int sms = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  const float* c = static_cast<const float*>(coef);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool d = drop != 0;
  if (is_bf16)
    err = split ? launch<__nv_bfloat16, true>(x, ll, bnd, c, out, m, seed, threshold, inv_keep, d,
                                              sms, s)
                : launch<__nv_bfloat16, false>(x, ll, bnd, c, out, m, seed, threshold, inv_keep,
                                               d, sms, s);
  else
    err = split ? launch<float, true>(x, ll, bnd, c, out, m, seed, threshold, inv_keep, d, sms, s)
                : launch<float, false>(x, ll, bnd, c, out, m, seed, threshold, inv_keep, d, sms,
                                       s);
  return int(err);
}

}  // namespace

// Both entries launch on `stream` of card `device` (the caller's tensors'
// card: this library's runtime keeps its own current device) and return the
// CUDA error of the launch (0 = launched). Every input view must be 16-byte
// aligned (the bulk copies' rule).

// K1: x [m,256], ll [m,48], bnd [m,1] row-major.
extern "C" int uda_mask_head_split(const void* x, const void* ll, const void* bnd,
                                   const void* coef, void* out, long long m,
                                   unsigned long long seed, unsigned int threshold,
                                   float inv_keep, int drop, int is_bf16, int device,
                                   void* stream) {
  return run(x, ll, bnd, coef, out, m, true, seed, threshold, inv_keep, drop, is_bf16, device,
             stream);
}

// K2: x_bu [m,304], bnd [m,1] row-major; the element index of channel c of
// row r is r*305 + c, as in K1, so K2 on cat(x_up, ll) equals K1 bitwise.
extern "C" int uda_mask_head(const void* x_bu, const void* bnd, const void* coef, void* out,
                             long long m, unsigned long long seed, unsigned int threshold,
                             float inv_keep, int drop, int is_bf16, int device, void* stream) {
  return run(x_bu, nullptr, bnd, coef, out, m, false, seed, threshold, inv_keep, drop, is_bf16,
             device, stream);
}

// The launch shape of one instance: dynamic shared memory per block (bytes)
// and resident blocks per SM, as the entries above size their grid.
extern "C" int uda_mask_head_occupancy(int split, int drop, int is_bf16, int device,
                                       int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  *smem_bytes = is_bf16 ? Tile<__nv_bfloat16>::kSmemBytes : Tile<float>::kSmemBytes;
  if (is_bf16)
    err = split ? (drop ? occupancy<__nv_bfloat16, true, true>(blocks_per_sm)
                        : occupancy<__nv_bfloat16, true, false>(blocks_per_sm))
                : (drop ? occupancy<__nv_bfloat16, false, true>(blocks_per_sm)
                        : occupancy<__nv_bfloat16, false, false>(blocks_per_sm));
  else
    err = split ? (drop ? occupancy<float, true, true>(blocks_per_sm)
                        : occupancy<float, true, false>(blocks_per_sm))
                : (drop ? occupancy<float, false, true>(blocks_per_sm)
                        : occupancy<float, false, false>(blocks_per_sm));
  return int(err);
}
