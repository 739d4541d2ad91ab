// Train-mode BatchNorm over (N, C, L) with an optional LeakyReLU fused in:
// two kernels forward, two backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's BatchNorm is flax's, which XLA
// fuses. On the card, ATen's train-mode BatchNorm of a bf16 NCHW tensor
// with float32 parameters (the UNet under autocast; ATen keeps cuDNN for
// float32) runs its native kernels, which launch ONE BLOCK PER CHANNEL for
// the statistics and for the backward reduction: at the UNet's widest
// level, 16 channels of (24, 256, 256), that is 16 blocks on 132 SMs, each
// reducing 1.57 M elements. Those kernels took 54% of the graphed
// mean-teacher step (22.7 ms of 41.9). The LeakyReLU that follows every
// BatchNorm of the UNet's ConvBlock was a pass of its own.
//
// What it computes, for x (N, C, L) contiguous, L the product of the
// spatial sides, M = N * L values a channel:
//   mean_c, var_c = the batch mean and BIASED variance of channel c,
//   invstd_c = 1 / sqrt(var_c + eps), a_c = invstd_c * w_c,
//   z = (x - mean_c) * a_c + b_c,   y = z > 0 ? z : slope * z,
// slope 1 being the identity, w = 1 and b = 0 without affine parameters;
// optionally the running statistics' update with the batch mean and the
// biased variance (flax's rule): r = (1 - momentum) r + momentum batch.
// Backward, with g = dy where z > 0, else slope * dy (z recomputed from x):
//   db_c = sum g,   dw_c = invstd_c * sum g (x - mean_c),
//   dx = a_c * (g - db_c / M - (x - mean_c) * invstd_c * dw_c / M).
//
// Bound: bytes. A few float32 operations per element, against ~20 per byte
// at which the float32 units would take over. Each input read once and each
// output written once, at bf16: forward 4 bytes an element (x in, y out),
// backward 6 (dy and x in, dx out); at (24, 16, 256, 256) 100.7 MB forward
// (30.0 us at 3.35 TB/s) and 151.0 MB backward (45.1 us).
//
// What the design does about it:
// * The per-channel reduction is split over many blocks a channel
//   (`splits`, chosen by the wrapper from N * L and C alone, so that every
//   layer of the UNet fills the card: about two waves of resident blocks,
//   no more blocks than packs over threads). Block (c, s) walks a contiguous
//   range of channel c's packs across its N planes; where a plane is
//   small, one block covers several planes. Loads are 16 bytes (8 bf16 or
//   4 f32) where every plane starts on a 16-byte boundary, four in flight
//   a thread; otherwise the whole tensor takes a scalar loop.
// * Statistics: Welford within a 16-byte pack (its mean and squared
//   deviations), Chan's merge into the thread's (count, mean, M2), then a
//   fixed-order tree over the block. Each block writes one row and draws
//   a ticket of its channel (one acquire-release atomic); the block that
//   draws the last merges the channel's rows in split order, writes the
//   mean, variance and invstd, updates the running statistics and resets
//   the ticket. Deterministic, and safe inside a CUDA graph.
// * Two passes each way (reduce, then apply), since a channel's values
//   do not fit on chip: the apply kernels walk the blocks in reverse order,
//   so they start on the bytes the reduce kernel read last, still in L2.
// * The LeakyReLU runs inside the apply passes, and its derivative inside
//   the backward's: no pass of its own, and no activation output saved.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (cvssl_tpu_torch/ops/_cuda_build.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // 16-byte loads in flight a thread (per input)

// Loads and stores of one pack: W values of T, 16 bytes (W > 1) or one.
template <typename T, int W>
struct Io;

template <>
struct Io<float, 4> {
  using R = uint4;
  static __device__ __forceinline__ R load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ float get(const R& r, int i) {
    return __uint_as_float(i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<__nv_bfloat16, 8> {
  using R = uint4;
  static __device__ __forceinline__ R load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  // value 2k of a word in its low half
  static __device__ __forceinline__ float get(const R& r, int i) {
    const int k = i >> 1;
    const uint32_t w = k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  static __device__ __forceinline__ uint32_t two(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        two(v[0], v[1]), two(v[2], v[3]), two(v[4], v[5]), two(v[6], v[7]));
  }
};

template <>
struct Io<float, 1> {
  using R = float;
  static __device__ __forceinline__ R load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float get(const R& r, int) { return r; }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};

template <>
struct Io<__nv_bfloat16, 1> {
  using R = unsigned short;
  static __device__ __forceinline__ R load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ float get(const R& r, int) {
    return __uint_as_float((uint32_t)r << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    *reinterpret_cast<unsigned short*>(p) =
        __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
  }
};

struct Geometry {
  int N, C, L;  // x is (N, C, L), contiguous
  int Lp;       // packs a plane: L / W
  int splits;   // blocks a channel
  int per;      // packs a block (the channel's last block takes the rest)
  int dn, dl;   // THREADS / Lp, THREADS % Lp: one thread step in (n, pack)
};

// The packs that this thread owns in block (c, s): pack j of the channel is
// pack l = j % Lp of plane n = j / Lp, at element ((n C + c) L + l W); the
// thread takes j = lo + threadIdx.x, then steps by THREADS, keeping (n, l)
// without a division.
template <int W>
struct Walker {
  int j, hi, n, l;
  __device__ __forceinline__ Walker(const Geometry& g, int s) {
    const int lo = s * g.per;
    hi = min(lo + g.per, g.N * g.Lp);
    j = lo + threadIdx.x;
    n = j / g.Lp;
    l = j - n * g.Lp;
  }
  __device__ __forceinline__ bool more(int k) const {
    return j + (k - 1) * THREADS < hi;
  }
  __device__ __forceinline__ long long take(const Geometry& g, int c) {
    const long long at = ((long long)n * g.C + c) * g.L + (long long)l * W;
    j += THREADS;
    n += g.dn;
    l += g.dl;
    if (l >= g.Lp) {
      l -= g.Lp;
      ++n;
    }
    return at;
  }
};

// Chan's merge of (nb, mb, qb) into (n, m, q): counts, means, sums of
// squared deviations from the mean.
__device__ __forceinline__ void merge(float& n, float& m, float& q, float nb,
                                      float mb, float qb) {
  if (nb <= 0.f) return;
  const float nn = n + nb;
  const float r = nb / nn;
  const float d = mb - m;
  m = fmaf(d, r, m);
  q += qb + d * d * n * r;
  n = nn;
}

// Merge every thread's (n, m, q) in a fixed order: a tree within each warp,
// then warps 0..WARPS-1. Thread 0 holds the result; every thread must call.
__device__ __forceinline__ void block_merge(float& n, float& m, float& q,
                                            float (*red)[WARPS]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, m, off);
    const float qb = __shfl_down_sync(0xffffffffu, q, off);
    merge(n, m, q, nb, mb, qb);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = n;
    red[1][warp] = m;
    red[2][warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int w = 1; w < WARPS; ++w) merge(n, m, q, red[0][w], red[1][w],
                                          red[2][w]);
  __syncthreads();
}

// Sum two values over the block in a fixed order (a tree within each
// warp, then warps 0..WARPS-1); thread 0 holds the sums.
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*red)[WARPS]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
  __syncthreads();
}

// One atomic increment of the ticket with acquire-release semantics at
// device scope: it releases the row this thread wrote before it, and
// acquires those of every block that drew an earlier ticket.
__device__ __forceinline__ unsigned int draw_ticket(unsigned int* ticket) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// The pre-activation and its activation's derivative factor, computed the
// same way in every kernel, so the backward takes the forward's branch.
__device__ __forceinline__ float pre(float x, float mean, float a, float b) {
  return fmaf(x - mean, a, b);
}
__device__ __forceinline__ float act(float z, float slope) {
  return z > 0.f ? z : z * slope;
}
__device__ __forceinline__ float act_grad(float z, float dy, float slope) {
  return z > 0.f ? dy : dy * slope;
}

// Statistics: rows part[3 * (c * splits + s)] = (count, mean, M2) of block
// (c, s); the last block of channel c writes stats[c], [C + c], [2C + c] =
// mean, biased variance, invstd and updates the running statistics.
template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
bnact_stats_kernel(const T* __restrict__ x, Geometry g, float eps,
                   float momentum, float* __restrict__ run_mean,
                   float* __restrict__ run_var, float* __restrict__ part,
                   unsigned int* __restrict__ tickets,
                   float* __restrict__ stats) {
  using IO = Io<T, W>;
  __shared__ float red[3][WARPS];
  __shared__ bool last;
  const int c = blockIdx.x / g.splits, s = blockIdx.x - c * g.splits;

  float n = 0.f, m = 0.f, q = 0.f;
  auto consume = [&](const typename IO::R& r) {
    float v[W];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      v[i] = IO::get(r, i);
      sum += v[i];
    }
    const float mp = sum * (1.f / W);
    float qp = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float d = v[i] - mp;
      qp = fmaf(d, d, qp);
    }
    merge(n, m, q, (float)W, mp, qp);
  };
  Walker<W> w(g, s);
  while (w.more(UNROLL)) {
    typename IO::R r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) r[u] = IO::load(x + w.take(g, c));
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) consume(r[u]);
  }
  while (w.more(1)) consume(IO::load(x + w.take(g, c)));

  block_merge(n, m, q, red);
  if (threadIdx.x == 0) {
    float* row = part + 3 * (long long)blockIdx.x;
    row[0] = n;
    row[1] = m;
    row[2] = q;
    last = draw_ticket(tickets + c) == (unsigned int)g.splits - 1u;
  }
  __syncthreads();
  if (!last) return;

  // the channel's last block, which acquired every row with its ticket:
  // merge them in split order (L2 reads)
  n = m = q = 0.f;
  const float* rows = part + 3 * (long long)c * g.splits;
  for (int r = threadIdx.x; r < g.splits; r += THREADS)
    merge(n, m, q, __ldcg(rows + 3 * r), __ldcg(rows + 3 * r + 1),
          __ldcg(rows + 3 * r + 2));
  block_merge(n, m, q, red);
  if (threadIdx.x == 0) {
    const float var = q / n;
    stats[c] = m;
    stats[g.C + c] = var;
    stats[2 * g.C + c] = 1.f / sqrtf(var + eps);
    run_mean[c] = fmaf(momentum, m, (1.f - momentum) * run_mean[c]);
    run_var[c] = fmaf(momentum, var, (1.f - momentum) * run_var[c]);
    tickets[c] = 0u;  // ready for the next launch
  }
}

// y = act((x - mean) invstd w + b), blocks in reverse order.
template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
bnact_apply_kernel(const T* __restrict__ x, Geometry g,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float slope,
                   const float* __restrict__ stats, T* __restrict__ y) {
  using IO = Io<T, W>;
  const int blk = gridDim.x - 1 - blockIdx.x;
  const int c = blk / g.splits, s = blk - c * g.splits;
  const float mean = stats[c];
  const float a = stats[2 * g.C + c] * (weight ? weight[c] : 1.f);
  const float b = bias ? bias[c] : 0.f;
  auto emit = [&](long long at, const typename IO::R& r) {
    float v[W];
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = act(pre(IO::get(r, i), mean, a, b),
                                           slope);
    IO::store(y + at, v);
  };
  Walker<W> w(g, s);
  while (w.more(UNROLL)) {
    long long at[UNROLL];
    typename IO::R r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      at[u] = w.take(g, c);
      r[u] = IO::load(x + at[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) emit(at[u], r[u]);
  }
  while (w.more(1)) {
    const long long at = w.take(g, c);
    emit(at, IO::load(x + at));
  }
}

// Backward sums: rows part[2 * (c * splits + s)] = (sum g, sum g (x -
// mean)) of block (c, s); the last block of channel c writes gsum[c] = db_c
// = sum g and gsum[C + c] = dw_c = invstd_c sum g (x - mean_c).
template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
bnact_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        Geometry g, const float* __restrict__ weight,
                        const float* __restrict__ bias, float slope,
                        const float* __restrict__ stats,
                        float* __restrict__ part,
                        unsigned int* __restrict__ tickets,
                        float* __restrict__ gsum) {
  using IO = Io<T, W>;
  __shared__ float red[3][WARPS];
  __shared__ bool last;
  const int c = blockIdx.x / g.splits, s = blockIdx.x - c * g.splits;
  const float mean = stats[c];
  const float a = stats[2 * g.C + c] * (weight ? weight[c] : 1.f);
  const float b = bias ? bias[c] : 0.f;

  float sg = 0.f, sgd = 0.f;
  auto consume = [&](const typename IO::R& rx, const typename IO::R& rd) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float xv = IO::get(rx, i);
      const float gv = act_grad(pre(xv, mean, a, b), IO::get(rd, i), slope);
      sg += gv;
      sgd = fmaf(gv, xv - mean, sgd);
    }
  };
  Walker<W> w(g, s);
  while (w.more(UNROLL)) {
    typename IO::R rx[UNROLL], rd[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long at = w.take(g, c);
      rx[u] = IO::load(x + at);
      rd[u] = IO::load(dy + at);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) consume(rx[u], rd[u]);
  }
  while (w.more(1)) {
    const long long at = w.take(g, c);
    consume(IO::load(x + at), IO::load(dy + at));
  }

  block_sum2(sg, sgd, red);
  if (threadIdx.x == 0) {
    float* row = part + 2 * (long long)blockIdx.x;
    row[0] = sg;
    row[1] = sgd;
    last = draw_ticket(tickets + c) == (unsigned int)g.splits - 1u;
  }
  __syncthreads();
  if (!last) return;

  sg = sgd = 0.f;
  const float* rows = part + 2 * (long long)c * g.splits;
  for (int r = threadIdx.x; r < g.splits; r += THREADS) {
    sg += __ldcg(rows + 2 * r);
    sgd += __ldcg(rows + 2 * r + 1);
  }
  block_sum2(sg, sgd, red);
  if (threadIdx.x == 0) {
    gsum[c] = sg;
    gsum[g.C + c] = sgd * stats[2 * g.C + c];
    tickets[c] = 0u;
  }
}

// dx = a (g - db / M - (x - mean) invstd dw / M), blocks in reverse order.
template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
bnact_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       Geometry g, const float* __restrict__ weight,
                       const float* __restrict__ bias, float slope,
                       const float* __restrict__ stats,
                       const float* __restrict__ gsum, float count,
                       T* __restrict__ dx) {
  using IO = Io<T, W>;
  const int blk = gridDim.x - 1 - blockIdx.x;
  const int c = blk / g.splits, s = blk - c * g.splits;
  const float mean = stats[c], invstd = stats[2 * g.C + c];
  const float a = invstd * (weight ? weight[c] : 1.f);
  const float b = bias ? bias[c] : 0.f;
  const float k1 = gsum[c] / count;
  const float k2 = gsum[g.C + c] * invstd / count;
  auto emit = [&](long long at, const typename IO::R& rx,
                  const typename IO::R& rd) {
    float v[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float xv = IO::get(rx, i);
      const float gv = act_grad(pre(xv, mean, a, b), IO::get(rd, i), slope);
      v[i] = a * (gv - k1 - (xv - mean) * k2);
    }
    IO::store(dx + at, v);
  };
  Walker<W> w(g, s);
  while (w.more(UNROLL)) {
    long long at[UNROLL];
    typename IO::R rx[UNROLL], rd[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      at[u] = w.take(g, c);
      rx[u] = IO::load(x + at[u]);
      rd[u] = IO::load(dy + at[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) emit(at[u], rx[u], rd[u]);
  }
  while (w.more(1)) {
    const long long at = w.take(g, c);
    emit(at, IO::load(x + at), IO::load(dy + at));
  }
}

Geometry geometry(int N, int C, int L, int vec, int splits, int per,
                  int W) {
  Geometry g;
  g.N = N;
  g.C = C;
  g.L = L;
  g.Lp = vec ? L / W : L;
  g.splits = splits;
  g.per = per;
  g.dn = THREADS / g.Lp;
  g.dl = THREADS % g.Lp;
  return g;
}

template <typename T, int W>
cudaError_t forward(const void* x, void* y, Geometry g, const float* w,
                    const float* b, float eps, float slope, float momentum,
                    float* run_mean, float* run_var, float* part,
                    unsigned int* tickets, float* stats, cudaStream_t s) {
  const int grid = g.C * g.splits;
  bnact_stats_kernel<T, W><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), g, eps, momentum, run_mean, run_var, part,
      tickets, stats);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bnact_apply_kernel<T, W><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), g, w, b, slope, stats, static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t backward(const void* x, const void* dy, void* dx, Geometry g,
                     const float* w, const float* b, float slope,
                     const float* stats, float* part, unsigned int* tickets,
                     float* gsum, cudaStream_t s) {
  const int grid = g.C * g.splits;
  bnact_bwd_reduce_kernel<T, W><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), g, w, b, slope,
      stats, part, tickets, gsum);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bnact_bwd_apply_kernel<T, W><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), g, w, b, slope,
      stats, gsum, (float)g.N * (float)g.L, static_cast<T*>(dx));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y (N, C, L) contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// vec = 1: every plane starts on a 16-byte boundary and L is a multiple of
// 16 / element size (16-byte packs), else 0 (one value a pack). The grid
// is C * splits blocks, `per` packs a block. w, b: C floats or null (1, 0);
// slope: the LeakyReLU's (1: the identity). run_mean, run_var: C floats
// updated with `momentum`. part: 3 * C * splits floats of scratch;
// tickets: C zeroed uint32, left zeroed; stats: 3C floats (mean, biased
// variance, invstd). Launches on `stream`; returns cudaGetLastError().
int bnact_fwd_launch(const void* x, void* y, int bf16, int vec, int N, int C,
                     int L, int splits, int per, const float* w,
                     const float* b, float eps, float slope, float momentum,
                     float* run_mean, float* run_var, float* part,
                     unsigned int* tickets, float* stats, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (vec)
      return (int)forward<__nv_bfloat16, 8>(
          x, y, geometry(N, C, L, 1, splits, per, 8), w, b, eps, slope,
          momentum, run_mean, run_var, part, tickets, stats, s);
    return (int)forward<__nv_bfloat16, 1>(
        x, y, geometry(N, C, L, 0, splits, per, 1), w, b, eps, slope,
        momentum, run_mean, run_var, part, tickets, stats, s);
  }
  if (vec)
    return (int)forward<float, 4>(x, y, geometry(N, C, L, 1, splits, per, 4),
                                  w, b, eps, slope, momentum, run_mean,
                                  run_var, part, tickets, stats, s);
  return (int)forward<float, 1>(x, y, geometry(N, C, L, 0, splits, per, 1),
                                w, b, eps, slope, momentum, run_mean, run_var,
                                part, tickets, stats, s);
}

// As the forward; dy, dx like x; stats: the forward's 3C floats; part:
// 2 * C * splits floats of scratch; gsum: 2C floats (db, dw).
int bnact_bwd_launch(const void* x, const void* dy, void* dx, int bf16,
                     int vec, int N, int C, int L, int splits, int per,
                     const float* w, const float* b, float slope,
                     const float* stats, float* part, unsigned int* tickets,
                     float* gsum, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (vec)
      return (int)backward<__nv_bfloat16, 8>(
          x, dy, dx, geometry(N, C, L, 1, splits, per, 8), w, b, slope, stats,
          part, tickets, gsum, s);
    return (int)backward<__nv_bfloat16, 1>(
        x, dy, dx, geometry(N, C, L, 0, splits, per, 1), w, b, slope, stats,
        part, tickets, gsum, s);
  }
  if (vec)
    return (int)backward<float, 4>(x, dy, dx,
                                   geometry(N, C, L, 1, splits, per, 4), w, b,
                                   slope, stats, part, tickets, gsum, s);
  return (int)backward<float, 1>(x, dy, dx,
                                 geometry(N, C, L, 0, splits, per, 1), w, b,
                                 slope, stats, part, tickets, gsum, s);
}

const char* bnact_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
