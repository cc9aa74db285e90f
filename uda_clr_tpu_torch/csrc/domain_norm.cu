// The domain-aware batch norm for Hopper (sm_90a), forward and backward (K4).
//
// Replaces no Pallas kernel: the JAX package leaves the norm
// (uda_clr_tpu/models/norm.py) to XLA's fusion. The port ran it op by op
// (models/norm.py's plain version: a float32 copy of x, its square, two
// reductions, three bf16 passes and their autograd nodes, ~34 host ops a
// site). Here a site is two launches forward and two backward, on an
// activation x [N, C, H, W] in bf16 or float32, laid out channels_last
// (NHWC in memory) or contiguous NCHW, its images split at k into at most
// two groups (rows [:k] source, [k:] target):
//
//   moments   float32 [sum x, sum x^2] per (group, channel) and each
//             group's count, from x itself (no float copy);
//   forward   mean = sum/n, var = max(sum2/n - mean^2, 0), rstd =
//             rsqrt(var + eps) per (group, channel), or a given mean and
//             var; y = (x - mean) * (rstd * scale) + bias in float32,
//             rounded once to x's type. Its first block of each channel
//             tile also keeps mean and rstd for the backward and writes
//             the running stats' EMA in place (momentum m, unbiased
//             n/(n-1)), group 1 before group 0, as the plain version does;
//   reduce    [sum dy, sum dy * xhat] per (group, channel);
//   dx        rstd * scale * (dy - sum dy / n - xhat * sum(dy xhat) / n),
//             or rstd * scale * dy where the statistics were given.
//
// Every reduction is deterministic: each block reduces its rows in a
// fixed order into a partial row, and a second kernel sums the partials
// of each (group, channel) in chunk order, so a run repeats bit for bit
// (float atomics would not).
//
// Bound: bytes. Per element in bf16: moments read x (2 B), forward reads
// x and writes y (4 B), reduce reads dy and x (4 B), dx reads both and
// writes dx (6 B); 16 B in all against ~70-80 B of the op-by-op version.
// Design: channels_last is [rows = N*H*W, C] row-major; a thread owns one
// vector of V channels (16 bytes where C and the pointers allow it, fewer
// otherwise) and walks rows with 4 loads in flight; a block is lanes x
// rows_per_pass threads, lanes = the channel vectors of its tile, so
// consecutive threads read consecutive addresses. The grid is chunks of
// rows (never across the group boundary) x channel tiles, about 4 blocks
// of at most 256 threads per SM (16 KB of loads in flight per block; 8
// blocks where C allows no 16-byte vector), with 16 row passes per thread
// at least: [16, 96, 258, 258] runs 528 blocks,
// the small late site [16, 320, 32, 32] 172 blocks of 96 rows; the
// partial rows stay a few percent of x's bytes. The wrapper
// (ops/domain_norm.py) plans it from what it sees: C, N*H*W, the type,
// the layout, the pointers' alignment and the SM count. NCHW (the tests
// and edge cases; the card's activations are channels_last) reduces one
// (image, channel) plane a block and normalizes plane chunks. The forward
// runs right after the moments on the same stream, so at the sites whose
// activation fits the 50 MB L2 its read of x mostly hits L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads of a block at most
constexpr int kUnroll = 4;     // loads in flight per thread

struct F32 {
  using Raw = float;
  static __device__ __forceinline__ float to_f(Raw v) { return v; }
  static __device__ __forceinline__ Raw from_f(float v) { return v; }
};

struct Bf16 {
  using Raw = unsigned short;
  static __device__ __forceinline__ float to_f(Raw v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
  static __device__ __forceinline__ Raw from_f(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <typename Raw, int V>
struct alignas(sizeof(Raw) * V) Pack {
  Raw v[V];
};

template <class E, int V>
__device__ __forceinline__ void load(const typename E::Raw* p, float (&out)[V]) {
  const Pack<typename E::Raw, V> pk = *reinterpret_cast<const Pack<typename E::Raw, V>*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = E::to_f(pk.v[j]);
}

template <class E, int V>
__device__ __forceinline__ void store(typename E::Raw* p, const float (&in)[V]) {
  Pack<typename E::Raw, V> pk;
#pragma unroll
  for (int j = 0; j < V; ++j) pk.v[j] = E::from_f(in[j]);
  *reinterpret_cast<Pack<typename E::Raw, V>*>(p) = pk;
}

// The launch's shape, as the wrapper planned it.
struct Geom {
  long long hw;       // H * W
  int n, c;           // images, channels
  int k;              // images of group 0 (n when there is one group)
  int groups;         // 1 or 2
  int lanes;          // channels_last: channel vectors of a tile (threads per row)
  int rows_per_pass;  // channels_last: rows a block covers per pass
  int chunks0, chunks1;  // channels_last: row chunks of each group; NCHW: k, n - k
};

__device__ __forceinline__ long long group_rows(const Geom& g, int grp) {
  return (grp == 0 ? (long long)g.k : (long long)(g.n - g.k)) * g.hw;
}

// The rows [r0, r1) (channels_last) of row chunk `chunk`, and its group.
struct Span {
  long long r0, r1;
  int grp;
};

__device__ __forceinline__ Span chunk_span(const Geom& g, int chunk) {
  const int grp = chunk >= g.chunks0 ? 1 : 0;
  const long long j = grp ? chunk - g.chunks0 : chunk;
  const long long chunks = grp ? g.chunks1 : g.chunks0;
  const long long rows = group_rows(g, grp);
  const long long first = grp ? (long long)g.k * g.hw : 0;
  const long long per = (rows + chunks - 1) / chunks;
  const long long r0 = j * per < rows ? j * per : rows;
  const long long r1 = r0 + per < rows ? r0 + per : rows;
  return {first + r0, first + r1, grp};
}

// Per (group, channel) statistics and affine of a forward. `counts` null:
// `a` and `b` are the mean and the biased variance; else the sums of x and
// x^2 over each group's `counts[group]` elements.
struct Stats {
  const float* a;
  const float* b;
  const float* counts;
  const float* scale;  // [c], one affine for both groups
  const float* bias;
  float eps;
};

__device__ __forceinline__ void mean_var(const Stats& s, int c, int grp, int ch, float& mean,
                                         float& var) {
  const int i = grp * c + ch;
  if (s.counts) {
    const float n = s.counts[grp];
    mean = __fdiv_rn(s.a[i], n);
    var = fmaxf(__fsub_rn(__fdiv_rn(s.b[i], n), __fmul_rn(mean, mean)), 0.f);
  } else {
    mean = s.a[i];
    var = s.b[i];
  }
}

// The running stats' EMA: group g's statistics go into (mean[g], var[g]),
// group 1 first; null pointers: no update.
struct Ema {
  float* mean[2];
  float* var[2];
  float momentum, keep;  // m and 1 - m
};

// One block's share of the per-channel epilogue of a forward, channels
// [c0, c1): keep mean and rstd ([2][groups][c]) and update the running
// stats.
__device__ void write_stats(const Stats& s, const Geom& g, float* saved, const Ema& ema, int c0,
                            int c1) {
  for (int ch = c0 + threadIdx.x; ch < c1; ch += blockDim.x) {
    for (int grp = g.groups - 1; grp >= 0; --grp) {
      float mean, var;
      mean_var(s, g.c, grp, ch, mean, var);
      if (saved) {
        saved[grp * g.c + ch] = mean;
        saved[(g.groups + grp) * g.c + ch] = rsqrtf(__fadd_rn(var, s.eps));
      }
      float* rm = ema.mean[grp];
      float* rv = ema.var[grp];
      if (rm && s.counts) {
        const float n = s.counts[grp];
        const float unbias = __fdiv_rn(n, fmaxf(__fsub_rn(n, 1.f), 1.f));
        rm[ch] = __fadd_rn(__fmul_rn(ema.keep, rm[ch]), __fmul_rn(ema.momentum, mean));
        rv[ch] = __fadd_rn(__fmul_rn(ema.keep, rv[ch]),
                           __fmul_rn(ema.momentum, __fmul_rn(var, unbias)));
      }
    }
  }
}

// The block's sums acc[V][2] of its rows, per lane, written as partial row
// blockIdx.x ([chunks][2][c]) after a fixed-order sum over the block's
// rows_per_pass row lanes.
template <int V>
__device__ void block_partial(const float (&acc)[V][2], float* partial, const Geom& g,
                              int lane, int rr, int cv0) {
  __shared__ float red[kThreads * V * 2];
  const int width = g.lanes * V * 2;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[rr * width + (lane * V + j) * 2] = acc[j][0];
    red[rr * width + (lane * V + j) * 2 + 1] = acc[j][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    float sum = 0.f;
    for (int r = 0; r < g.rows_per_pass; ++r) sum += red[r * width + i];
    const int ch = cv0 * V + i / 2;
    if (ch < g.c) partial[((long long)blockIdx.x * 2 + (i & 1)) * g.c + ch] = sum;
  }
}

// moments (channels_last): acc = [sum x, sum x^2] of each of the thread's
// V channels over its rows.
template <class E, int V>
__global__ void __launch_bounds__(kThreads)
domain_norm_moments_cl(const typename E::Raw* __restrict__ x, float* __restrict__ partial,
                       Geom g) {
  const int lane = threadIdx.x % g.lanes, rr = threadIdx.x / g.lanes;
  const int cv0 = blockIdx.y * g.lanes, cv = cv0 + lane;
  const Span s = chunk_span(g, blockIdx.x);
  float acc[V][2];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j][0] = acc[j][1] = 0.f;
  if (cv * V < g.c) {
    const typename E::Raw* base = x + (long long)cv * V;
    const int step = g.rows_per_pass;
    long long r = s.r0 + rr;
    for (; r + (kUnroll - 1) * step < s.r1; r += kUnroll * step) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load<E, V>(base + (r + u * step) * g.c, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc[j][0] += v[u][j];
          acc[j][1] = fmaf(v[u][j], v[u][j], acc[j][1]);
        }
    }
    for (; r < s.r1; r += step) {
      float v[V];
      load<E, V>(base + r * g.c, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[j][0] += v[j];
        acc[j][1] = fmaf(v[j], v[j], acc[j][1]);
      }
    }
  }
  block_partial<V>(acc, partial, g, lane, rr, cv0);
}

// reduce (channels_last): acc = [sum dy, sum dy * (x - mean)].
template <class E, int V>
__global__ void __launch_bounds__(kThreads)
domain_norm_bwd_reduce_cl(const typename E::Raw* __restrict__ dy,
                          const typename E::Raw* __restrict__ x,
                          const float* __restrict__ saved, float* __restrict__ partial, Geom g) {
  const int lane = threadIdx.x % g.lanes, rr = threadIdx.x / g.lanes;
  const int cv0 = blockIdx.y * g.lanes, cv = cv0 + lane;
  const Span s = chunk_span(g, blockIdx.x);
  float acc[V][2];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j][0] = acc[j][1] = 0.f;
  if (cv * V < g.c) {
    float mean[V];
#pragma unroll
    for (int j = 0; j < V; ++j) mean[j] = saved[s.grp * g.c + cv * V + j];
    const long long off = (long long)cv * V;
    const int step = g.rows_per_pass;
    long long r = s.r0 + rr;
    for (; r + (kUnroll - 1) * step < s.r1; r += kUnroll * step) {
      float d[kUnroll][V], v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load<E, V>(dy + off + (r + u * step) * g.c, d[u]);
        load<E, V>(x + off + (r + u * step) * g.c, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc[j][0] += d[u][j];
          acc[j][1] = fmaf(d[u][j], v[u][j] - mean[j], acc[j][1]);
        }
    }
    for (; r < s.r1; r += step) {
      float d[V], v[V];
      load<E, V>(dy + off + r * g.c, d);
      load<E, V>(x + off + r * g.c, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[j][0] += d[j];
        acc[j][1] = fmaf(d[j], v[j] - mean[j], acc[j][1]);
      }
    }
  }
  block_partial<V>(acc, partial, g, lane, rr, cv0);
}

// forward (channels_last).
template <class E, int V>
__global__ void __launch_bounds__(kThreads)
domain_norm_forward_cl(const typename E::Raw* __restrict__ x, typename E::Raw* __restrict__ y,
                       Stats st, Geom g, float* __restrict__ saved, Ema ema) {
  const int lane = threadIdx.x % g.lanes, rr = threadIdx.x / g.lanes;
  const int cv0 = blockIdx.y * g.lanes, cv = cv0 + lane;
  const Span s = chunk_span(g, blockIdx.x);
  if (cv * V < g.c) {
    float mean[V], mul[V], add[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int ch = cv * V + j;
      float var;
      mean_var(st, g.c, s.grp, ch, mean[j], var);
      mul[j] = __fmul_rn(rsqrtf(__fadd_rn(var, st.eps)), st.scale[ch]);
      add[j] = st.bias[ch];
    }
    const long long off = (long long)cv * V;
    const int step = g.rows_per_pass;
    long long r = s.r0 + rr;
    for (; r + (kUnroll - 1) * step < s.r1; r += kUnroll * step) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load<E, V>(x + off + (r + u * step) * g.c, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          v[u][j] = __fadd_rn(__fmul_rn(__fsub_rn(v[u][j], mean[j]), mul[j]), add[j]);
        store<E, V>(y + off + (r + u * step) * g.c, v[u]);
      }
    }
    for (; r < s.r1; r += step) {
      float v[V];
      load<E, V>(x + off + r * g.c, v);
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[j], mean[j]), mul[j]), add[j]);
      store<E, V>(y + off + r * g.c, v);
    }
  }
  if (blockIdx.x == 0) {
    const int c1 = (cv0 + g.lanes) * V;
    write_stats(st, g, saved, ema, cv0 * V, c1 < g.c ? c1 : g.c);
  }
}

// The dx coefficients of one (group, channel): dx = mul * dy + (x - mean) *
// slope + shift.
struct DxCoef {
  float mean, mul, slope, shift;
};

__device__ __forceinline__ DxCoef dx_coef(const float* saved, const float* red,
                                          const float* counts, const float* scale, const Geom& g,
                                          int grp, int ch) {
  DxCoef k;
  k.mean = saved[grp * g.c + ch];
  const float rstd = saved[(g.groups + grp) * g.c + ch];
  k.mul = __fmul_rn(rstd, scale[ch]);
  k.slope = k.shift = 0.f;
  if (red) {
    const float n = counts[grp];
    const float mdy = __fdiv_rn(red[grp * g.c + ch], n);
    const float mdyx = __fdiv_rn(red[(g.groups + grp) * g.c + ch], n);
    k.shift = -__fmul_rn(k.mul, mdy);
    k.slope = -__fmul_rn(__fmul_rn(k.mul, rstd), mdyx);
  }
  return k;
}

// dx (channels_last).
template <class E, int V>
__global__ void __launch_bounds__(kThreads)
domain_norm_bwd_dx_cl(const typename E::Raw* __restrict__ dy, const typename E::Raw* __restrict__ x,
                      typename E::Raw* __restrict__ dx, const float* __restrict__ saved,
                      const float* __restrict__ red, const float* __restrict__ counts,
                      const float* __restrict__ scale, Geom g) {
  const int lane = threadIdx.x % g.lanes, rr = threadIdx.x / g.lanes;
  const int cv = blockIdx.y * g.lanes + lane;
  const Span s = chunk_span(g, blockIdx.x);
  if (cv * V >= g.c) return;
  DxCoef k[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    k[j] = dx_coef(saved, red, counts, scale, g, s.grp, cv * V + j);
  const long long off = (long long)cv * V;
  const int step = g.rows_per_pass;
  long long r = s.r0 + rr;
  for (; r + (kUnroll - 1) * step < s.r1; r += kUnroll * step) {
    float d[kUnroll][V], v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load<E, V>(dy + off + (r + u * step) * g.c, d[u]);
      load<E, V>(x + off + (r + u * step) * g.c, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        d[u][j] = fmaf(k[j].mul, d[u][j], fmaf(v[u][j] - k[j].mean, k[j].slope, k[j].shift));
      store<E, V>(dx + off + (r + u * step) * g.c, d[u]);
    }
  }
  for (; r < s.r1; r += step) {
    float d[V], v[V];
    load<E, V>(dy + off + r * g.c, d);
    load<E, V>(x + off + r * g.c, v);
#pragma unroll
    for (int j = 0; j < V; ++j)
      d[j] = fmaf(k[j].mul, d[j], fmaf(v[j] - k[j].mean, k[j].slope, k[j].shift));
    store<E, V>(dx + off + r * g.c, d);
  }
}

// --- contiguous NCHW: block (channel, image) reduces one H*W plane ---

// Fixed-order tree sum of a block's two values per thread; the result in
// thread 0.
__device__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads], sb[kThreads];
  sa[threadIdx.x] = a;
  sb[threadIdx.x] = b;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      sa[threadIdx.x] += sa[threadIdx.x + w];
      sb[threadIdx.x] += sb[threadIdx.x + w];
    }
    __syncthreads();
  }
  a = sa[0];
  b = sb[0];
}

// moments (NCHW, dy null) or reduce (NCHW, dy given): partial row n of
// channel c is the plane's [sum x, sum x^2] or [sum dy, sum dy (x - mean)].
template <class E, int V>
__global__ void __launch_bounds__(kThreads)
domain_norm_plane_sums(const typename E::Raw* __restrict__ dy, const typename E::Raw* __restrict__ x,
                       const float* __restrict__ saved, float* __restrict__ partial, Geom g) {
  const int ch = blockIdx.x, img = blockIdx.y;
  const int grp = img < g.k ? 0 : 1;
  const long long plane = ((long long)img * g.c + ch) * g.hw;
  const float mean = dy ? saved[grp * g.c + ch] : 0.f;
  float a = 0.f, b = 0.f;
  for (long long i = (long long)threadIdx.x * V; i < g.hw; i += (long long)kThreads * V) {
    float v[V];
    load<E, V>(x + plane + i, v);
    if (dy) {
      float d[V];
      load<E, V>(dy + plane + i, d);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a += d[j];
        b = fmaf(d[j], v[j] - mean, b);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a += v[j];
        b = fmaf(v[j], v[j], b);
      }
    }
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    partial[((long long)img * 2) * g.c + ch] = a;
    partial[((long long)img * 2 + 1) * g.c + ch] = b;
  }
}

// forward (NCHW): block (plane, piece) normalizes kThreads * V * kUnroll
// elements of plane blockIdx.x; block (0, 0) writes the epilogue of every
// channel.
template <class E, int V>
__global__ void __launch_bounds__(kThreads)
domain_norm_forward_nchw(const typename E::Raw* __restrict__ x, typename E::Raw* __restrict__ y,
                         Stats st, Geom g, float* __restrict__ saved, Ema ema) {
  const long long p = blockIdx.x;
  const int ch = int(p % g.c), img = int(p / g.c);
  const int grp = img < g.k ? 0 : 1;
  float mean, var;
  mean_var(st, g.c, grp, ch, mean, var);
  const float mul = __fmul_rn(rsqrtf(__fadd_rn(var, st.eps)), st.scale[ch]);
  const float add = st.bias[ch];
  const long long piece = (long long)kThreads * V * kUnroll;
  const long long end0 = (long long)(blockIdx.y + 1) * piece;
  const long long end = end0 < g.hw ? end0 : g.hw;
  for (long long i = blockIdx.y * piece + (long long)threadIdx.x * V; i < end;
       i += (long long)kThreads * V) {
    float v[V];
    load<E, V>(x + p * g.hw + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[j], mean), mul), add);
    store<E, V>(y + p * g.hw + i, v);
  }
  if (blockIdx.x == 0 && blockIdx.y == 0) write_stats(st, g, saved, ema, 0, g.c);
}

// dx (NCHW), blocks as the forward's.
template <class E, int V>
__global__ void __launch_bounds__(kThreads)
domain_norm_bwd_dx_nchw(const typename E::Raw* __restrict__ dy,
                        const typename E::Raw* __restrict__ x, typename E::Raw* __restrict__ dx,
                        const float* __restrict__ saved, const float* __restrict__ red,
                        const float* __restrict__ counts, const float* __restrict__ scale,
                        Geom g) {
  const long long p = blockIdx.x;
  const int ch = int(p % g.c), img = int(p / g.c);
  const DxCoef k = dx_coef(saved, red, counts, scale, g, img < g.k ? 0 : 1, ch);
  const long long piece = (long long)kThreads * V * kUnroll;
  const long long end0 = (long long)(blockIdx.y + 1) * piece;
  const long long end = end0 < g.hw ? end0 : g.hw;
  for (long long i = blockIdx.y * piece + (long long)threadIdx.x * V; i < end;
       i += (long long)kThreads * V) {
    float d[V], v[V];
    load<E, V>(dy + p * g.hw + i, d);
    load<E, V>(x + p * g.hw + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) d[j] = fmaf(k.mul, d[j], fmaf(v[j] - k.mean, k.slope, k.shift));
    store<E, V>(dx + p * g.hw + i, d);
  }
}

// out[s][grp][c] = the sum of partial rows of group grp of sum s, times
// mul1[grp][c] for s = 1 where given; with `counts`, out's tail [groups]
// is each group's element count. Block (channel tile, s * groups + grp):
// kCombineSlices slices of kCombineLanes channels, slice i summing the
// chunks i, i + kCombineSlices, ... in order, then the slices in order.
constexpr int kCombineLanes = 32, kCombineSlices = kThreads / kCombineLanes;

__global__ void __launch_bounds__(kThreads)
domain_norm_combine(const float* __restrict__ partial, float* __restrict__ out,
                    const float* __restrict__ mul1, int counts, Geom g) {
  __shared__ float red[kThreads];
  const int lane = threadIdx.x % kCombineLanes, slice = threadIdx.x / kCombineLanes;
  const int ch = blockIdx.x * kCombineLanes + lane;
  const int s = blockIdx.y / g.groups, grp = blockIdx.y % g.groups;
  const int j0 = grp ? g.chunks0 : 0, j1 = grp ? g.chunks0 + g.chunks1 : g.chunks0;
  float sum = 0.f;
  if (ch < g.c)
    for (int j = j0 + slice; j < j1; j += kCombineSlices)
      sum += partial[((long long)j * 2 + s) * g.c + ch];
  red[threadIdx.x] = sum;
  __syncthreads();
  if (slice == 0 && ch < g.c) {
    for (int i = 1; i < kCombineSlices; ++i) sum += red[i * kCombineLanes + lane];
    if (mul1 && s == 1) sum = __fmul_rn(sum, mul1[grp * g.c + ch]);
    out[(s * g.groups + grp) * g.c + ch] = sum;
  }
  if (counts && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x < g.groups)
    out[2 * g.groups * g.c + threadIdx.x] = float(group_rows(g, threadIdx.x));
}

// TransNorm's transferability factor a1[c] = 1 + C p[c] / sum(p), p = 1 /
// (1 + |mu_s / sigma_s - mu_t / sigma_t|), sigma = sqrt(unbiased var + eps),
// from a two-group moments buffer (group 0 source, 1 target): one block,
// the sum over the channels in a fixed order.
__global__ void __launch_bounds__(kThreads)
domain_norm_tn_factor(const float* __restrict__ stats, int c, float eps, float* __restrict__ a1) {
  __shared__ float red[kThreads];
  const float* n = stats + 4 * c;
  float part = 0.f;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float r[2];
    for (int grp = 0; grp < 2; ++grp) {
      const float mean = __fdiv_rn(stats[grp * c + ch], n[grp]);
      const float var = fmaxf(__fsub_rn(__fdiv_rn(stats[(2 + grp) * c + ch], n[grp]),
                                        __fmul_rn(mean, mean)), 0.f);
      const float unbias = __fdiv_rn(n[grp], fmaxf(__fsub_rn(n[grp], 1.f), 1.f));
      r[grp] = __fmul_rn(mean, rsqrtf(__fadd_rn(__fmul_rn(var, unbias), eps)));
    }
    const float p = __fdiv_rn(1.f, __fadd_rn(1.f, fabsf(__fsub_rn(r[0], r[1]))));
    a1[ch] = p;
    part += p;
  }
  red[threadIdx.x] = part;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  const float total = red[0];
  for (int ch = threadIdx.x; ch < c; ch += kThreads)
    a1[ch] = __fadd_rn(1.f, __fdiv_rn(__fmul_rn(float(c), a1[ch]), total));
}

// Dispatch on (bf16, vector width).
template <template <class, int> class Fn, typename... A>
cudaError_t dispatch(int is_bf16, int vec, A... args) {
  if (is_bf16) {
    switch (vec) {
      case 8: return Fn<Bf16, 8>::run(args...);
      case 4: return Fn<Bf16, 4>::run(args...);
      case 2: return Fn<Bf16, 2>::run(args...);
      case 1: return Fn<Bf16, 1>::run(args...);
    }
  } else {
    switch (vec) {
      case 4: return Fn<F32, 4>::run(args...);
      case 2: return Fn<F32, 2>::run(args...);
      case 1: return Fn<F32, 1>::run(args...);
    }
  }
  return cudaErrorInvalidValue;
}

struct Launch {
  dim3 grid, block;
  cudaStream_t stream;
};

// The grid of a channels_last pass (row chunks x channel tiles) or of an
// NCHW elementwise pass (planes x pieces).
Launch rows_launch(const Geom& g, int cl, int vec, int tiles, cudaStream_t s) {
  if (cl)
    return {dim3(g.chunks0 + g.chunks1, tiles), dim3(g.lanes * g.rows_per_pass), s};
  const long long piece = (long long)kThreads * vec * kUnroll;
  return {dim3((unsigned)((long long)g.n * g.c), (unsigned)((g.hw + piece - 1) / piece)),
          dim3(kThreads), s};
}

template <class E, int V>
struct Sums {  // moments (dy null) or reduce
  static cudaError_t run(const void* dy, const void* x, const float* saved, float* partial,
                         Geom g, int cl, int tiles, cudaStream_t s) {
    using R = typename E::Raw;
    if (g.chunks0 + g.chunks1 == 0) return cudaSuccess;
    if (!cl) {
      domain_norm_plane_sums<E, V><<<dim3(g.c, g.n), kThreads, 0, s>>>(
          static_cast<const R*>(dy), static_cast<const R*>(x), saved, partial, g);
    } else if (dy) {
      const Launch l = rows_launch(g, cl, V, tiles, s);
      domain_norm_bwd_reduce_cl<E, V><<<l.grid, l.block, 0, s>>>(
          static_cast<const R*>(dy), static_cast<const R*>(x), saved, partial, g);
    } else {
      const Launch l = rows_launch(g, cl, V, tiles, s);
      domain_norm_moments_cl<E, V><<<l.grid, l.block, 0, s>>>(static_cast<const R*>(x), partial,
                                                               g);
    }
    return cudaGetLastError();
  }
};

template <class E, int V>
struct Forward {
  static cudaError_t run(const void* x, void* y, Stats st, Geom g, float* saved, Ema ema, int cl,
                         int tiles, cudaStream_t s) {
    using R = typename E::Raw;
    const Launch l = rows_launch(g, cl, V, tiles, s);
    if (cl)
      domain_norm_forward_cl<E, V><<<l.grid, l.block, 0, s>>>(
          static_cast<const R*>(x), static_cast<R*>(y), st, g, saved, ema);
    else
      domain_norm_forward_nchw<E, V><<<l.grid, l.block, 0, s>>>(
          static_cast<const R*>(x), static_cast<R*>(y), st, g, saved, ema);
    return cudaGetLastError();
  }
};

template <class E, int V>
struct Dx {
  static cudaError_t run(const void* dy, const void* x, void* dx, const float* saved,
                         const float* red, const float* counts, const float* scale, Geom g,
                         int cl, int tiles, cudaStream_t s) {
    using R = typename E::Raw;
    const Launch l = rows_launch(g, cl, V, tiles, s);
    if (cl)
      domain_norm_bwd_dx_cl<E, V><<<l.grid, l.block, 0, s>>>(
          static_cast<const R*>(dy), static_cast<const R*>(x), static_cast<R*>(dx), saved, red,
          counts, scale, g);
    else
      domain_norm_bwd_dx_nchw<E, V><<<l.grid, l.block, 0, s>>>(
          static_cast<const R*>(dy), static_cast<const R*>(x), static_cast<R*>(dx), saved, red,
          counts, scale, g);
    return cudaGetLastError();
  }
};

Geom geom(int n, int c, long long hw, int k, int groups, int lanes, int rows_per_pass, int chunks0,
          int chunks1) {
  return {hw, n, c, k, groups, lanes, rows_per_pass, chunks0, chunks1};
}

cudaError_t combine(const float* partial, float* out, const float* mul1, int counts, Geom g,
                    cudaStream_t s) {
  const dim3 grid((g.c + kCombineLanes - 1) / kCombineLanes, 2 * g.groups);
  domain_norm_combine<<<grid, kThreads, 0, s>>>(partial, out, mul1, counts, g);
  return cudaGetLastError();
}

bool empty(int n, int c, long long hw) { return n <= 0 || c <= 0 || hw <= 0; }

}  // namespace

// Every entry takes the wrapper's plan of the launch: x [n, c, H, W] with hw
// = H*W, its first k images in group 0 (k = n: one group), `cl` 1 for
// channels_last, `vec` the elements per vector access (every pointer of the
// activation's type aligned to it), and for channels_last the lanes, rows
// per pass, channel tiles and each group's row chunks (NCHW: chunks0 = k,
// chunks1 = n - k). It launches on `stream` of card `device` and returns
// cudaGetLastError() after its launches (0 = launched).

// moments: out = [sum x][groups][c], [sum x^2][groups][c], then the
// groups' counts (float32); `partial` holds (chunks0 + chunks1) * 2 * c
// floats.
extern "C" int uda_norm_moments(const void* x, float* partial, float* out, int n, int c,
                                long long hw, int k, int groups, int cl, int vec, int lanes,
                                int rows_per_pass, int tiles, int chunks0, int chunks1,
                                int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g = geom(n, c, hw, k, groups, lanes, rows_per_pass, chunks0, chunks1);
  if (!empty(n, c, hw)) {
    err = dispatch<Sums>(is_bf16, vec, static_cast<const void*>(nullptr), x,
                         static_cast<const float*>(nullptr), partial, g, cl, tiles, s);
    if (err != cudaSuccess) return int(err);
  }
  return int(combine(partial, out, nullptr, 1, g, s));
}

// forward: y from x. With `counts` (non-null), `a` and `b` are the moments'
// sums over counts[group] elements (the batch statistics), else the mean
// and the biased variance (running statistics, constants). `scale` and
// `bias` (float32 [c]) serve both groups. `saved` (null: not kept)
// receives [mean][groups][c], [rstd][groups][c]. With `counts`, each
// non-null running (mean, var) pair of a group takes the EMA at
// `momentum`.
extern "C" int uda_norm_forward(const void* x, void* y, const float* a, const float* b,
                                const float* counts, const float* scale, const float* bias,
                                float eps, float* saved,
                                float* run_mean0, float* run_var0, float* run_mean1,
                                float* run_var1, float momentum, float keep, int n, int c,
                                long long hw, int k, int groups, int cl, int vec, int lanes,
                                int rows_per_pass, int tiles, int chunks0, int chunks1,
                                int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (empty(n, c, hw) || (cl && chunks0 + chunks1 == 0)) return 0;
  const Stats st = {a, b, counts, scale, bias, eps};
  const Ema ema = {{run_mean0, run_mean1}, {run_var0, run_var1}, momentum, keep};
  const Geom g = geom(n, c, hw, k, groups, lanes, rows_per_pass, chunks0, chunks1);
  return int(dispatch<Forward>(is_bf16, vec, x, y, st, g, saved, ema, cl, tiles,
                               static_cast<cudaStream_t>(stream)));
}

// reduce: out = [sum dy][groups][c], [sum dy * xhat][groups][c], with the
// forward's `saved` mean and rstd; `partial` as the moments'.
extern "C" int uda_norm_bwd_reduce(const void* dy, const void* x, const float* saved,
                                   float* partial, float* out, int n, int c, long long hw, int k,
                                   int groups, int cl, int vec, int lanes, int rows_per_pass,
                                   int tiles, int chunks0, int chunks1, int is_bf16, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g = geom(n, c, hw, k, groups, lanes, rows_per_pass, chunks0, chunks1);
  if (!empty(n, c, hw)) {
    err = dispatch<Sums>(is_bf16, vec, dy, x, saved, partial, g, cl, tiles, s);
    if (err != cudaSuccess) return int(err);
  }
  return int(combine(partial, out, saved + groups * c, 0, g, s));
}

// dx from dy, x, the forward's `saved` mean and rstd and `scale`; `red`
// (the reduce's out, summed over the ranks) and the groups' `counts` for
// batch statistics, null for constant ones.
extern "C" int uda_norm_bwd_dx(const void* dy, const void* x, void* dx, const float* saved,
                               const float* red, const float* counts, const float* scale,
                               int n, int c, long long hw, int k, int groups,
                               int cl, int vec, int lanes, int rows_per_pass, int tiles,
                               int chunks0, int chunks1, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (empty(n, c, hw) || (cl && chunks0 + chunks1 == 0)) return 0;
  const Geom g = geom(n, c, hw, k, groups, lanes, rows_per_pass, chunks0, chunks1);
  return int(dispatch<Dx>(is_bf16, vec, dy, x, dx, saved, red, counts, scale, g, cl, tiles,
                          static_cast<cudaStream_t>(stream)));
}

// TransNorm's a1 [c] from a two-group moments buffer (see
// domain_norm_tn_factor).
extern "C" int uda_norm_tn_factor(const float* stats, int c, float eps, float* a1, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  domain_norm_tn_factor<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(stats, c, eps, a1);
  return int(cudaGetLastError());
}
