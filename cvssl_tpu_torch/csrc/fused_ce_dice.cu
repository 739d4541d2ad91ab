// Fused softmax cross-entropy + Dice over NCHW logits: a one-launch forward
// and a one-launch backward for Hopper (sm_90a).
//
// Replaces the TPU kernel cvssl_tpu/ops/pallas_kernels.py::fused_ce_dice_tpu
// (body _fused_reduction_kernel, pallas_call :84) and its closed-form VJP
// _fused_bwd (:131). For logits (B, C, HW) and integer labels (B, HW), per
// site p = softmax over the C classes and y = one-hot(label); over all
// n = B * HW sites
//   CE = sum -log p[y],  I_c = sum p_c y_c,  P_c = sum p_c^2,  L_c = sum y_c
//   ce = CE / n,  dice = mean_c 1 - (2 I_c + s) / (P_c + L_c + s),  s = 1e-5.
// The backward is _fused_bwd's closed form with separate cotangents:
//   grad = g_ce (p - y) / n + g_dice p (gp - sum_k gp_k p_k),
//   gp_c = (-2 y_c + 2 p_c (2 I_c + s) / D_c) / D_c / C,  D_c = P_c + L_c + s,
// with the per-class divisions hoisted into one reciprocal per block.
// A label outside [0, C) is a site with no one-hot class: it adds to P and
// to the softmax terms, not to CE, I or L.
//
// Bound: bytes. Per site some 10 C operations on C logits and one label,
// far below the ~20 per byte at which the float32 units would take over. At
// (12, 4, 256, 256) bf16 logits with int32 labels the forward reads 9.4 MB
// (2.8 us at 3.35 TB/s), the backward also writes 6.3 MB (4.7 us).
//
// What the design does about it:
// * One launch each, on a persistent grid (blocks_per_sm x SMs, capped by
//   the work) of 256 threads. Each thread walks 16-byte chunks of one
//   batch item in a grid-stride loop: one 16-byte load per class plane
//   (8 bf16 or 4 f32 sites) and one vector load of the chunk's labels,
//   read in place from NCHW, two chunks in flight for C <= 8. Sites that
//   are not a whole aligned chunk take a scalar loop (the wrapper decides,
//   from data_ptr() % 16 and HW, which sites those are).
// * The forward keeps 1 + 3C sums in float32 registers, reduces them in the
//   block with warp shuffles and then shared memory in a fixed order, and
//   writes one row per block, then draws a ticket with one acquire-release
//   atomic add; the block that draws the last one sums the rows in
//   block-index order, writes ce, dice and (I, P, L), and resets the ticket.
//   The result is deterministic: bit-equal from call to call.
// * The backward recomputes the softmax per chunk from the logits and the
//   3C saved sums, and writes the gradient in the logits' dtype with
//   16-byte stores: one read and one write of every byte.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (cvssl_tpu_torch/ops/_cuda_build.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float SMOOTH = 1e-5f;
constexpr float LOG2E = 1.4426950408889634f;

// Resident blocks per SM that ptxas must leave registers for. At C = 4 on
// an H100, 3 ran faster than no bound (the forward then fits only 2) and
// than 4 (which spills more).
constexpr int min_blocks(int C) { return C <= 4 ? 3 : C <= 8 ? 2 : 1; }

// Site i (compile-time after unrolling) of a 16-byte chunk of one class
// plane: 4 f32 or 8 bf16 sites, element 2k of a bf16 word in its low half.
__device__ __forceinline__ uint32_t word(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int i);

template <>
__device__ __forceinline__ float elem<float>(const uint4& r, int i) {
  return __uint_as_float(word(r, i));
}

template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& r, int i) {
  const uint32_t w = word(r, i >> 1);
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Write site i's value g into the chunk's 4 words w, in T.
template <typename T>
__device__ __forceinline__ void put(uint32_t* w, int i, float g);

template <>
__device__ __forceinline__ void put<float>(uint32_t* w, int i, float g) {
  w[i] = __float_as_uint(g);
}

template <>
__device__ __forceinline__ void put<__nv_bfloat16>(uint32_t* w, int i,
                                                   float g) {
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(g));
  w[i >> 1] = (i & 1) ? (w[i >> 1] | (h << 16)) : h;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float g) { *p = g; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float g) {
  *p = __float2bfloat16_rn(g);
}

// the N labels of a chunk in one vector load (16 bytes of int32 twice for
// N = 8; 4 or 8 bytes of uint8)
template <int N>
__device__ __forceinline__ void load_labels(const int32_t* p, int* y) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p) + i);
    y[4 * i] = t.x;
    y[4 * i + 1] = t.y;
    y[4 * i + 2] = t.z;
    y[4 * i + 3] = t.w;
  }
}

template <int N>
__device__ __forceinline__ void load_labels(const uint8_t* p, int* y) {
  if constexpr (N == 4) {
    const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = (w >> (8 * i)) & 0xff;
  } else {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y[i] = (w.x >> (8 * i)) & 0xff;
      y[4 + i] = (w.y >> (8 * i)) & 0xff;
    }
  }
}

// exp2 and 1/x as single MUFU operations (ex2.approx: 2 ulp; rcp.approx:
// 1 ulp); their arguments here are bounded (x <= 0, 1 <= s <= C).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Softmax of one site over C classes, in place; sets m = max x and returns
// s = sum exp(x - m), so that log p[y] = x[y] - m - log s.
template <int C>
__device__ __forceinline__ float softmax(float* x, float& m) {
  m = x[0];
#pragma unroll
  for (int c = 1; c < C; ++c) m = fmaxf(m, x[c]);
  const float ml = m * LOG2E;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x[c] = fast_exp2(fmaf(x[c], LOG2E, -ml));
    s += x[c];
  }
  const float inv = fast_rcp(s);
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] *= inv;
  return s;
}

// Forward sums of one site: acc = [CE, I_0.., P_0.., L_0..].
template <int C>
__device__ __forceinline__ void accumulate(const float* x, int y,
                                           float* acc) {
  float p[C];
  float xy = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    p[c] = x[c];
    xy = (y == c) ? x[c] : xy;
  }
  float m;
  const float s = softmax<C>(p, m);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const bool hit = (y == c);
    acc[1 + c] += hit ? p[c] : 0.f;
    acc[1 + C + c] = fmaf(p[c], p[c], acc[1 + C + c]);
    acc[1 + 2 * C + c] += hit ? 1.f : 0.f;
  }
  acc[0] += ((unsigned)y < (unsigned)C) ? __logf(s) - (xy - m) : 0.f;
}

// Per-block constants of the backward, from stats (I, P, L) and the
// cotangents: gp_c = (two_ratio_c p_c - 2 y_c) inv_dc_c.
template <int C>
struct BwdConst {
  float two_ratio[C], inv_dc[C], gce_n, gdice;
};

// Gradient of one site, written over x.
template <int C>
__device__ __forceinline__ void grad_site(float* x, int y,
                                          const BwdConst<C>& k) {
  float m;
  softmax<C>(x, m);
  float gp[C];
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float yc = (y == c) ? 1.f : 0.f;
    gp[c] = (k.two_ratio[c] * x[c] - 2.f * yc) * k.inv_dc[c];
    dot = fmaf(gp[c], x[c], dot);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float yc = (y == c) ? 1.f : 0.f;
    x[c] = k.gce_n * (x[c] - yc) + k.gdice * x[c] * (gp[c] - dot);
  }
}

// One atomic increment of the ticket with acquire-release semantics at
// device scope (one instruction, where a fence, atomicAdd and a fence were
// slower): it releases this block's writes that a barrier ordered before
// it, and acquires those of every block that drew an earlier ticket.
__device__ __forceinline__ unsigned int draw_ticket(unsigned int* ticket) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// Sum K values over the block in a fixed order: butterfly within each
// warp, then warps 0..WARPS-1. Thread j < K returns the total of value j
// in tot[j] (shared); every thread must call it.
template <int K>
__device__ __forceinline__ void block_sum(float* v, float (*red)[K],
                                          float* tot) {
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < K; ++j) red[warp][j] = v[j];
  __syncthreads();
  if (threadIdx.x < K) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += red[w][threadIdx.x];
    tot[threadIdx.x] = t;
  }
  __syncthreads();
}

struct Geometry {
  int B;
  int HW;      // sites per class plane
  int chunks;  // 16-byte chunks per item on the vector path (0: none)
  int tail;    // sites per item on the scalar loop, after the chunks
};

template <typename T, typename L, int C>
__global__ void __launch_bounds__(THREADS, min_blocks(C))
ce_dice_fwd_kernel(const T* __restrict__ x, const L* __restrict__ lab,
                   Geometry g, float n, float* __restrict__ part,
                   unsigned int* __restrict__ ticket,
                   float* __restrict__ out) {
  constexpr int N = 16 / sizeof(T);
  constexpr int K = 1 + 3 * C;
  constexpr bool PAIR = C <= 8;  // above, one chunk is >= 9 loads in flight
  __shared__ float red[WARPS][K];
  __shared__ float tot[K];
  __shared__ bool last;

  float acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 0.f;

  const int stride = gridDim.x * THREADS;
  const int nvec = g.B * g.chunks;
  auto load = [&](int i, uint4* r, int* y) {
    const int b = i / g.chunks;
    const long long site = (long long)(i - b * g.chunks) * N;
    const T* xb = x + (long long)b * C * g.HW + site;
#pragma unroll
    for (int c = 0; c < C; ++c)
      r[c] = __ldg(reinterpret_cast<const uint4*>(xb + (long long)c * g.HW));
    load_labels<N>(lab + (long long)b * g.HW + site, y);
  };
  auto consume = [&](const uint4* r, const int* y) {
#pragma unroll
    for (int s = 0; s < N; ++s) {
      float xs[C];
#pragma unroll
      for (int c = 0; c < C; ++c) xs[c] = elem<T>(r[c], s);
      accumulate<C>(xs, y[s], acc);
    }
  };
  int i = blockIdx.x * THREADS + threadIdx.x;
  if constexpr (PAIR) {
    for (; i + stride < nvec; i += 2 * stride) {
      uint4 r0[C], r1[C];
      int y0[N], y1[N];
      load(i, r0, y0);
      load(i + stride, r1, y1);
      consume(r0, y0);
      consume(r1, y1);
    }
  }
  for (; i < nvec; i += stride) {
    uint4 r[C];
    int y[N];
    load(i, r, y);
    consume(r, y);
  }
  // scalar loop: the last `tail` sites of every item
  const int ntail = g.B * g.tail;
  for (int t = blockIdx.x * THREADS + threadIdx.x; t < ntail; t += stride) {
    const int b = t / g.tail;
    const long long site = (long long)g.chunks * N + (t - b * g.tail);
    float xs[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      xs[c] = to_float(x[((long long)b * C + c) * g.HW + site]);
    accumulate<C>(xs, (int)lab[(long long)b * g.HW + site], acc);
  }

  // this block's row, column-major: part[j * gridDim.x + block]; then
  // thread 0 draws a ticket, releasing the row the barrier ordered before it
  block_sum<K>(acc, red, tot);
  if (threadIdx.x < K)
    part[threadIdx.x * gridDim.x + blockIdx.x] = tot[threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) last = draw_ticket(ticket) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block, which acquired every row with its ticket: sum them in
  // block-index order (L2 reads)
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 0.f;
  for (int r = threadIdx.x; r < gridDim.x; r += THREADS)
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] += __ldcg(part + j * gridDim.x + r);
  block_sum<K>(acc, red, tot);
  if (threadIdx.x == 0) {
    float dice = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      dice += 1.f - (2.f * tot[1 + c] + SMOOTH) /
                        (tot[1 + C + c] + tot[1 + 2 * C + c] + SMOOTH);
    out[0] = tot[0] / n;
    out[1] = dice / C;
#pragma unroll
    for (int j = 1; j < K; ++j) out[1 + j] = tot[j];
    *ticket = 0u;  // ready for the next launch
  }
}

template <typename T, typename L, int C>
__global__ void __launch_bounds__(THREADS, min_blocks(C))
ce_dice_bwd_kernel(const T* __restrict__ x, const L* __restrict__ lab,
                   Geometry g, float n, const float* __restrict__ stats,
                   const float* __restrict__ g_ce,
                   const float* __restrict__ g_dice, T* __restrict__ grad) {
  constexpr int N = 16 / sizeof(T);
  constexpr bool PAIR = C <= 8;
  __shared__ float sh[2 * C + 2];
  if (threadIdx.x < C) {
    const int c = threadIdx.x;
    const float denom = stats[C + c] + stats[2 * C + c] + SMOOTH;
    sh[c] = 2.f * ((2.f * stats[c] + SMOOTH) / denom);
    sh[C + c] = 1.f / (denom * C);
  } else if (threadIdx.x == C) {
    sh[2 * C] = *g_ce / n;
    sh[2 * C + 1] = *g_dice;
  }
  __syncthreads();
  BwdConst<C> k;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    k.two_ratio[c] = sh[c];
    k.inv_dc[c] = sh[C + c];
  }
  k.gce_n = sh[2 * C];
  k.gdice = sh[2 * C + 1];

  const int stride = gridDim.x * THREADS;
  const int nvec = g.B * g.chunks;
  auto base = [&](int i) {
    const int b = i / g.chunks;
    return (long long)b * C * g.HW + (long long)(i - b * g.chunks) * N;
  };
  auto load = [&](int i, uint4* r, int* y) {
    const int b = i / g.chunks;
    const long long site = (long long)(i - b * g.chunks) * N;
    const T* xb = x + base(i);
#pragma unroll
    for (int c = 0; c < C; ++c)
      r[c] = __ldg(reinterpret_cast<const uint4*>(xb + (long long)c * g.HW));
    load_labels<N>(lab + (long long)b * g.HW + site, y);
  };
  auto emit = [&](int i, const uint4* r, const int* y) {
    uint32_t w[C][4];
#pragma unroll
    for (int s = 0; s < N; ++s) {
      float xs[C];
#pragma unroll
      for (int c = 0; c < C; ++c) xs[c] = elem<T>(r[c], s);
      grad_site<C>(xs, y[s], k);
#pragma unroll
      for (int c = 0; c < C; ++c) put<T>(w[c], s, xs[c]);
    }
    T* gb = grad + base(i);
#pragma unroll
    for (int c = 0; c < C; ++c)
      *reinterpret_cast<uint4*>(gb + (long long)c * g.HW) =
          make_uint4(w[c][0], w[c][1], w[c][2], w[c][3]);
  };
  int i = blockIdx.x * THREADS + threadIdx.x;
  if constexpr (PAIR) {
    for (; i + stride < nvec; i += 2 * stride) {
      uint4 r0[C], r1[C];
      int y0[N], y1[N];
      load(i, r0, y0);
      load(i + stride, r1, y1);
      emit(i, r0, y0);
      emit(i + stride, r1, y1);
    }
  }
  for (; i < nvec; i += stride) {
    uint4 r[C];
    int y[N];
    load(i, r, y);
    emit(i, r, y);
  }
  const int ntail = g.B * g.tail;
  for (int t = blockIdx.x * THREADS + threadIdx.x; t < ntail; t += stride) {
    const int b = t / g.tail;
    const long long site = (long long)g.chunks * N + (t - b * g.tail);
    float xs[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      xs[c] = to_float(x[((long long)b * C + c) * g.HW + site]);
    grad_site<C>(xs, (int)lab[(long long)b * g.HW + site], k);
#pragma unroll
    for (int c = 0; c < C; ++c)
      store(grad + ((long long)b * C + c) * g.HW + site, xs[c]);
  }
}

struct Args {
  const void* x;
  const void* lab;
  Geometry g;
  float n;
  float* part;          // forward
  unsigned int* ticket; // forward
  float* out;           // forward
  const float* stats;   // backward
  const float* g_ce;    // backward
  const float* g_dice;  // backward
  void* grad;           // backward
  int grid;
};

// bwd = 0: forward, 1: backward. With occ, report the kernel's resident
// blocks per SM instead of launching it.
template <typename T, typename L, int C>
cudaError_t run(int bwd, const Args& a, cudaStream_t s, int* occ) {
  const void* fn = bwd ? (const void*)ce_dice_bwd_kernel<T, L, C>
                       : (const void*)ce_dice_fwd_kernel<T, L, C>;
  if (occ)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, fn, THREADS, 0);
  const T* x = static_cast<const T*>(a.x);
  const L* lab = static_cast<const L*>(a.lab);
  if (bwd)
    ce_dice_bwd_kernel<T, L, C><<<a.grid, THREADS, 0, s>>>(
        x, lab, a.g, a.n, a.stats, a.g_ce, a.g_dice, static_cast<T*>(a.grad));
  else
    ce_dice_fwd_kernel<T, L, C><<<a.grid, THREADS, 0, s>>>(
        x, lab, a.g, a.n, a.part, a.ticket, a.out);
  return cudaGetLastError();
}

template <typename T, typename L>
cudaError_t by_classes(int C, int bwd, const Args& a, cudaStream_t s,
                       int* occ) {
  switch (C) {
#define CASE(c) \
  case c:       \
    return run<T, L, c>(bwd, a, s, occ);
    CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)
    CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int bf16, int u8, int C, int bwd, const Args& a,
                     cudaStream_t s, int* occ) {
  if (bf16)
    return u8 ? by_classes<__nv_bfloat16, uint8_t>(C, bwd, a, s, occ)
              : by_classes<__nv_bfloat16, int32_t>(C, bwd, a, s, occ);
  return u8 ? by_classes<float, uint8_t>(C, bwd, a, s, occ)
            : by_classes<float, int32_t>(C, bwd, a, s, occ);
}

__global__ void noop_kernel() {}

}  // namespace

extern "C" {

// logits (B, C, HW) contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// labels (B, HW) contiguous, int32 (u8 = 0) or uint8 (u8 = 1); the first
// `chunks` * (16 / element size) sites of every item are 16-byte aligned
// chunks (logits and labels), the `tail` after them are read one by one.
// n = B * HW. part: grid * (1 + 3C) floats of scratch; ticket: one zeroed
// uint32, left zeroed; out: 2 + 3C floats (ce, dice, I, P, L). 2 <= C <= 16.
// Launches `grid` blocks on `stream`; returns cudaGetLastError().
int ce_dice_fwd_launch(const void* logits, int bf16, const void* labels,
                       int u8, int B, int C, int HW, int chunks, int tail,
                       float n, float* part, unsigned int* ticket, float* out,
                       int grid, void* stream) {
  Args a{};
  a.x = logits;
  a.lab = labels;
  a.g = Geometry{B, HW, chunks, tail};
  a.n = n;
  a.part = part;
  a.ticket = ticket;
  a.out = out;
  a.grid = grid;
  return (int)dispatch(bf16, u8, C, 0, a, static_cast<cudaStream_t>(stream),
                       nullptr);
}

// As the forward; stats: the forward's 3C floats (I, P, L); g_ce, g_dice:
// one float each on the device; grad: like logits.
int ce_dice_bwd_launch(const void* logits, int bf16, const void* labels,
                       int u8, int B, int C, int HW, int chunks, int tail,
                       float n, const float* stats, const float* g_ce,
                       const float* g_dice, void* grad, int grid,
                       void* stream) {
  Args a{};
  a.x = logits;
  a.lab = labels;
  a.g = Geometry{B, HW, chunks, tail};
  a.n = n;
  a.stats = stats;
  a.g_ce = g_ce;
  a.g_dice = g_dice;
  a.grad = grad;
  a.grid = grid;
  return (int)dispatch(bf16, u8, C, 1, a, static_cast<cudaStream_t>(stream),
                       nullptr);
}

// Resident blocks per SM of the forward (bwd = 0) or backward kernel of
// this type and class count, or -1 on error.
int ce_dice_blocks_per_sm(int bwd, int bf16, int u8, int C) {
  Args a{};
  int occ = 0;
  const cudaError_t e = dispatch(bf16, u8, C, bwd, a, nullptr, &occ);
  return e == cudaSuccess ? occ : -1;
}

// An empty kernel launched the way the others are: its event-timed time is
// the floor under every kernel time that chip_smoke.py reports.
int ce_dice_noop_launch(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

const char* ce_dice_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
