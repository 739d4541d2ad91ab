// SAME 3x3 stride-1 convolution, C = Co = 16, NHWC input (float32 or
// bfloat16), HWIO float32 weights, float32 output: three CUDA kernels for
// Hopper (sm_90a), one per TPU kernel of cvssl_tpu/ops/pallas_conv.py.
//
//   variant 0  conv3x3_p8      (_conv_kernel,     pallas_call :238)
//   variant 1  conv3x3_p8_dma  (_conv_kernel_dma, pallas_call :126)
//   variant 2  conv3x3_p8_db   (_conv_kernel_db,  pallas_call :194)
//
// The TPU kernels pack 8 pixels x 16 channels into a 128-lane vector and
// run nine banded 128x128 matmuls per row tile; the three variants differ
// in how input rows reach VMEM (three materialised dh-shifted views; one
// halo DMA per row tile; that DMA double-buffered). What each keeps out of
// device memory is translated here, not its blocks:
//
//   0: each thread computes one pixel's 16 outputs in registers from its
//      3x3x16 neighbourhood, read in place from device memory (L1/L2 serve
//      the nine-fold reuse); no shifted views, edges masked.
//   1: a block stages its (tile_h+2) x (TW+2) x 16 halo tile in shared
//      memory once with cp.async (zero-filled outside the image), then
//      computes every pixel of the tile from it.
//   2: a block walks a run of row tiles of one column strip of one image in
//      a loop (the TPU's sequential grid axis); a two-stage cp.async ring
//      prefetches tile t+1 while the block computes tile t. The product is
//      an implicit GEMM on the tensor cores (below).
//
// VMEM held the whole padded row span ((tile_h+8) x (W+16) x 64 B, ~696 KB
// at W = 256); a Hopper block has at most 227 KB of shared memory, so the
// tile kernels also tile W (TW columns). The TPU's 7 bottom pad rows served
// sublane alignment only and are gone.
//
// Arithmetic, variants 0 and 1: float32 FMAs on the CUDA cores, bfloat16
// inputs widened in registers, so results match the JAX kernels in
// interpret mode (true f32), not the TPU's single-pass bf16 MXU products.
//
// Arithmetic, variant 2: split TF32 on the tensor cores. Each output row of
// 16 pixels of a strip is an M = 16 tile, the 16 output channels two N = 8
// tiles, and each tap's 16 input channels two K = 8 steps of
// mma.sync.m16n8k8 .tf32 with f32 accumulators; the tap's shifted A view is
// read straight from the halo tile. One TF32 product keeps 11 significant
// bits, about 3e-4 of the largest output, far outside the port's 1e-5
// gate. So every operand is split as v = hi + lo, hi = tf32(v) (round to
// nearest, ties away), and f32 input takes three products, lo(x) hi(k) +
// hi(x) lo(k) + hi(x) hi(k), whose terms alone are within 1e-7 of the
// largest output; a bfloat16 input is exact in TF32, so it takes two,
// x lo(k) + x hi(k). The weights are split once per block. The tensor
// cores' float32 sums (54 products deep for f32 input) bring the error to
// about 1.5e-6 of the largest output on an H100.
//
// Bound (H100 SXM, 3.35 TB/s, 495 TFLOP/s dense TF32): at (24, 256, 256,
// 16) the f32 input + f32 output is 201,335,808 B (60.1 us; 45.1 us with
// bf16 input) and the conv is 7.25 GFLOP (14.6 us on the tensor cores, 108
// us as f32 FMAs on the CUDA cores), so the work is bound by bytes.
// Variants 0 and 1 are bound by their FMAs. Variant 2 issues 3 (f32) or 2
// (bf16) mma.sync per product, 21.7 or 14.5 GFLOP: at the dense TF32 rate
// 44 or 29 us, under the bytes, but mma.sync alone reaches about 290
// TFLOP/s on an H100 (chip_conv_variants.py --mma-rate), so its products
// take about 75 or 50 us, and they overlap the memory traffic only in part
// (the kernel's skeletons in chip_conv_variants.py add up to its time).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (done by cvssl_tpu_torch/ops/conv3x3_p8.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 16;                 // input = output channels
constexpr int KW = 9 * C * C;         // weights, floats
constexpr int THREADS = 256;
constexpr int TW_DMA = 32;            // tile width (pixels), variant 1
constexpr int TW_DB = 16;             // tile width (pixels) = M, variant 2
constexpr int R_DB = 2;               // output rows per warp, variant 2
constexpr int TILES_DB = 2;           // row tiles per block, variant 2
// variant 2's weights as split-TF32 B fragments: 9 taps x 4 (k-step, n-tile)
// x 32 lanes x float4
constexpr int KFRAG = 9 * 4 * 32;

__device__ __forceinline__ void widen16(const float* p, float v[C]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 t = q[i];
    v[4 * i] = t.x;
    v[4 * i + 1] = t.y;
    v[4 * i + 2] = t.z;
    v[4 * i + 3] = t.w;
  }
}

__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float v[C]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint4 t = q[i];
    uint32_t words[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      __nv_bfloat162 pair = *reinterpret_cast<__nv_bfloat162*>(&words[j]);
      float2 f = __bfloat1622float2(pair);
      v[8 * i + 2 * j] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

// acc[co] += sum_ci xin[ci] * w[ci][co]; w is one (dh, dw) tap in shared
// memory, read as float4 broadcasts.
__device__ __forceinline__ void tap(const float xin[C], const float* w,
                                    float acc[C]) {
#pragma unroll
  for (int ci = 0; ci < C; ++ci) {
    const float4* row = reinterpret_cast<const float4*>(w + ci * C);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4 ww = row[q];
      acc[4 * q] = fmaf(xin[ci], ww.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(xin[ci], ww.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(xin[ci], ww.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(xin[ci], ww.w, acc[4 * q + 3]);
    }
  }
}

__device__ __forceinline__ void store16(float* p, const float acc[C]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                       acc[4 * i + 3]);
}

__device__ __forceinline__ void load_weights(const float* __restrict__ k,
                                             float* wsm) {
  for (int i = threadIdx.x; i < KW; i += blockDim.x) wsm[i] = k[i];
}

// ---------------------------------------------------------------------------
// variant 0: one pixel per thread, neighbourhood read in place
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_direct(const T* __restrict__ x, const float* __restrict__ k,
            float* __restrict__ out, int B, int H, int W) {
  __shared__ __align__(16) float wsm[KW];
  load_weights(k, wsm);
  __syncthreads();
  const long long total = (long long)B * H * W;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < total; p += (long long)gridDim.x * blockDim.x) {
    const int w = (int)(p % W);
    const long long bh = p / W;
    const int h = (int)(bh % H);
    const long long b = bh / H;
    float acc[C];
#pragma unroll
    for (int i = 0; i < C; ++i) acc[i] = 0.f;
    // taps not unrolled: unrolled, ptxas hoists all nine neighbourhood
    // loads and spills (255 registers, 8 KB of stack)
#pragma unroll 1
    for (int dh = 0; dh < 3; ++dh) {
      const int hh = h + dh - 1;
      if (hh < 0 || hh >= H) continue;
#pragma unroll 1
      for (int dw = 0; dw < 3; ++dw) {
        const int ww = w + dw - 1;
        if (ww < 0 || ww >= W) continue;
        float xin[C];
        widen16(x + ((b * H + hh) * W + ww) * C, xin);
        tap(xin, wsm + (dh * 3 + dw) * C * C, acc);
      }
    }
    store16(out + p * C, acc);
  }
}

// ---------------------------------------------------------------------------
// variants 1 and 2: halo tiles in shared memory through cp.async
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of the (th+2) x (TW+2) halo tile whose top-left output
// pixel is (row0, col0) of image b; rows/columns outside the image are
// zero-filled (SAME padding).
template <typename T, int TW>
__device__ __forceinline__ void issue_tile(const T* __restrict__ x, T* tile,
                                           long long b, int row0, int col0,
                                           int th, int H, int W) {
  constexpr int PER = 16 / sizeof(T);      // elements per 16-byte chunk
  constexpr int CHUNKS = C / PER;          // chunks per pixel
  const int n = (th + 2) * (TW + 2) * CHUNKS;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int pix = i / CHUNKS, part = i % CHUNKS;
    const int r = pix / (TW + 2), c = pix % (TW + 2);
    const int gh = row0 + r - 1, gw = col0 + c - 1;
    const bool valid = gh >= 0 && gh < H && gw >= 0 && gw < W;
    const T* src = valid ? x + ((b * H + gh) * W + gw) * C + part * PER : x;
    cp_async16(tile + pix * C + part * PER, src, valid);
  }
}

template <typename T, int TW>
__device__ __forceinline__ void compute_tile(const T* tile, const float* wsm,
                                             float* __restrict__ out,
                                             long long b, int row0, int col0,
                                             int th, int H, int W) {
  for (int i = threadIdx.x; i < th * TW; i += blockDim.x) {
    const int r = i / TW, c = i % TW;
    const int gw = col0 + c;
    if (gw >= W) continue;  // ragged last column strip
    float acc[C];
#pragma unroll
    for (int q = 0; q < C; ++q) acc[q] = 0.f;
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        float xin[C];
        widen16(tile + ((r + dh) * (TW + 2) + c + dw) * C, xin);
        tap(xin, wsm + (dh * 3 + dw) * C * C, acc);
      }
    }
    store16(out + ((b * H + row0 + r) * W + gw) * C, acc);
  }
}

template <typename T, int TW>
__global__ void __launch_bounds__(THREADS)
conv_halo(const T* __restrict__ x, const float* __restrict__ k,
          float* __restrict__ out, int B, int H, int W, int th) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* wsm = reinterpret_cast<float*>(smem);
  T* tile = reinterpret_cast<T*>(smem + KW * sizeof(float));
  const int col0 = blockIdx.x * TW, row0 = blockIdx.y * th;
  const long long b = blockIdx.z;
  issue_tile<T, TW>(x, tile, b, row0, col0, th, H, W);
  cp_async_commit();
  load_weights(k, wsm);
  cp_async_wait<0>();
  __syncthreads();
  compute_tile<T, TW>(tile, wsm, out, b, row0, col0, th, H, W);
}

// ---------------------------------------------------------------------------
// variant 2: split-TF32 implicit GEMM on the tensor cores
// ---------------------------------------------------------------------------
// Fragments of mma.m16n8k8 .tf32 (lane = 4 g + t): A (16 x 8) a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8) b0 (t, g),
// b1 (t + 4, g); D (16 x 8) d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t),
// d3 (g + 8, 2t + 1). Rows of A are pixels, columns of D output channels.
// K runs over input channels in the order that lets one 16-byte load give a
// lane its A values of both k-steps: in k-step s, k = t is channel
// 4t + 2s and k = t + 4 channel 4t + 2s + 1. A warp's load of 8 pixels x 16
// channels is then one contiguous run of shared memory, free of bank
// conflicts without padding the pixel stride.

// cvt.rna.tf32.f32 for finite v: round to nearest, ties away from zero, to
// 10 mantissa bits (the low 13 bits of the result are 0). Two integer
// instructions; the cvt itself compiles to a longer compare-and-select
// sequence for sm_90a.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The weights as B fragments, split once: wfrag[(tap * 4 + 2s + n) * 32 +
// lane] = (hi b0, hi b1, lo b0, lo b1) of k-step s and n-tile n, so a warp
// reads one (tap, s, n) as 512 contiguous bytes.
__device__ __forceinline__ void load_weights_tf32(const float* __restrict__ k,
                                                  float4* wfrag) {
  for (int i = threadIdx.x; i < KFRAG; i += blockDim.x) {
    const int lane = i & 31, j = (i >> 5) & 3, tap = i >> 7;
    const int g = lane >> 2, t = lane & 3;
    const int ci = 4 * t + 2 * (j >> 1), co = 8 * (j & 1) + g;
    const float w0 = k[(tap * C + ci) * C + co];
    const float w1 = k[(tap * C + ci + 1) * C + co];
    const float h0 = __uint_as_float(tf32_rna(w0));
    const float h1 = __uint_as_float(tf32_rna(w1));
    wfrag[i] = make_float4(h0, h1, __uint_as_float(tf32_rna(w0 - h0)),
                           __uint_as_float(tf32_rna(w1 - h1)));
  }
}

// A values of one pixel for this lane: channels 4t .. 4t+3, as TF32 hi and
// lo parts (float32 input). lo = v - hi is exact in float32 and goes to the
// tensor cores as it is: they read a TF32 operand's top 19 bits, so lo is
// cut to TF32 there (an error of at most 2^-21 |v|), which saves rounding
// it here ...
__device__ __forceinline__ void load_a(const float* px, uint32_t hi[4],
                                       uint32_t lo[4]) {
  const float4 v = *reinterpret_cast<const float4*>(px);
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(f[i]);
    lo[i] = __float_as_uint(f[i] - __uint_as_float(hi[i]));
  }
}

// ... or exactly (bfloat16 input: its 8 mantissa bits fit TF32's 10; lo
// is 0 and unused)
__device__ __forceinline__ void load_a(const __nv_bfloat16* px,
                                       uint32_t hi[4], uint32_t lo[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(px);
  hi[0] = v.x << 16;
  hi[1] = v.x & 0xffff0000u;
  hi[2] = v.y << 16;
  hi[3] = v.y & 0xffff0000u;
#pragma unroll
  for (int i = 0; i < 4; ++i) lo[i] = 0u;
}

// Output rows o0 .. o0+NR-1 of the tile whose top output row is image row
// row0, by one warp: for each dw, the B fragments of the three dh taps stay
// in registers while the warp walks the NR + 2 input rows, and each input
// row's A fragment, loaded and split once, feeds every output row it
// reaches (dh = input row - output row).
template <typename T, int NR>
__device__ __forceinline__ void mma_rows(const T* tile, const float4* wfrag,
                                         float* __restrict__ out, long long b,
                                         int row0, int col0, int o0, int H,
                                         int W) {
  constexpr bool SPLIT_A = sizeof(T) == sizeof(float);
  constexpr int TW = TW_DB;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[NR][2][4];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.f;
#pragma unroll
  for (int dw = 0; dw < 3; ++dw) {
    float4 bw[3][4];
#pragma unroll
    for (int dh = 0; dh < 3; ++dh)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bw[dh][j] = wfrag[((dh * 3 + dw) * 4 + j) * 32 + lane];
#pragma unroll
    for (int i = 0; i < NR + 2; ++i) {
      const T* px = tile + ((o0 + i) * (TW + 2) + g + dw) * C + 4 * t;
      uint32_t hi0[4], lo0[4], hi8[4], lo8[4];  // pixels g and g + 8
      load_a(px, hi0, lo0);
      load_a(px + 8 * C, hi8, lo8);
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const int r = i - dh;
        if (r < 0 || r >= NR) continue;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint32_t ah[4] = {hi0[2 * s], hi8[2 * s], hi0[2 * s + 1],
                                  hi8[2 * s + 1]};
          const uint32_t al[4] = {lo0[2 * s], lo8[2 * s], lo0[2 * s + 1],
                                  lo8[2 * s + 1]};
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float4 w = bw[dh][2 * s + n];
            // small terms first
            if (SPLIT_A)
              mma_tf32(acc[r][n], al, __float_as_uint(w.x),
                       __float_as_uint(w.y));
            mma_tf32(acc[r][n], ah, __float_as_uint(w.z),
                     __float_as_uint(w.w));
            mma_tf32(acc[r][n], ah, __float_as_uint(w.x),
                     __float_as_uint(w.y));
          }
        }
      }
    }
  }
  // d (pixel g or g + 8, channels 8n + 2t, +1) -> float2 stores; pixels
  // past W (a ragged last strip) are computed and not stored
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float* row = out + ((b * H + row0 + o0 + r) * W) * C;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gw = col0 + g + 8 * half;
      if (gw >= W) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n)
        *reinterpret_cast<float2*>(row + gw * C + 8 * n + 2 * t) =
            make_float2(acc[r][n][2 * half], acc[r][n][2 * half + 1]);
    }
  }
}

// grid (strips, B, ceil(nt / TILES_DB)), nt = H / th: block (x, b, z)
// computes row tiles z * TILES_DB .. (at most TILES_DB, fewer at the end)
// of strip x of image b. Two tiles a block measured fastest at (24, 256,
// 256, 16): the ring overlaps the second tile's copy with the first's
// products, and the many short blocks keep every SM's two slots busy (one
// tile a block, or four or eight, was slower: chip_conv_variants.py).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
conv_halo_db(const T* __restrict__ x, const float* __restrict__ k,
             float* __restrict__ out, int B, int H, int W, int th) {
  constexpr int TW = TW_DB;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* wfrag = reinterpret_cast<float4*>(smem);
  T* ring = reinterpret_cast<T*>(smem + KFRAG * sizeof(float4));
  const int stage = (th + 2) * (TW + 2) * C;  // elements per ring slot
  const int col0 = blockIdx.x * TW;
  const long long b = blockIdx.y;
  const int t0 = blockIdx.z * TILES_DB, per = min(TILES_DB, H / th - t0);
  const int groups = (th + R_DB - 1) / R_DB;
  const int warp = threadIdx.x >> 5;
  issue_tile<T, TW>(x, ring, b, t0 * th, col0, th, H, W);
  cp_async_commit();
  load_weights_tf32(k, wfrag);
  for (int u = 0; u < per; ++u) {
    if (u + 1 < per) {
      // slot (u+1)&1 was last read in iteration u-1, which ended in a
      // barrier, so it is free
      issue_tile<T, TW>(x, ring + ((u + 1) & 1) * stage, b,
                        (t0 + u + 1) * th, col0, th, H, W);
      cp_async_commit();
      cp_async_wait<1>();  // tile u has landed; u+1 stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tile = ring + (u & 1) * stage;
    const int row0 = (t0 + u) * th;
    for (int q = warp; q < groups; q += THREADS / 32) {
      const int o0 = q * R_DB, nr = min(R_DB, th - o0);
      if (nr == R_DB)
        mma_rows<T, R_DB>(tile, wfrag, out, b, row0, col0, o0, H, W);
      else  // the short last group of a tile_h that R_DB does not divide
        for (int r = 0; r < nr; ++r)
          mma_rows<T, 1>(tile, wfrag, out, b, row0, col0, o0 + r, H, W);
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(int variant, const void* xv, const float* k, float* out,
                   int B, int H, int W, int th, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  if (variant == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long total = (long long)B * H * W;
    long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 8LL * sms) blocks = 8LL * sms;  // grid-stride beyond
    conv_direct<T><<<(unsigned)blocks, THREADS, 0, stream>>>(x, k, out, B,
                                                             H, W);
    return cudaGetLastError();
  }
  const size_t wbytes = KW * sizeof(float);
  if (variant == 1) {
    const size_t bytes =
        wbytes + (size_t)(th + 2) * (TW_DMA + 2) * C * sizeof(T);
    cudaError_t e = cudaFuncSetAttribute(
        conv_halo<T, TW_DMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((W + TW_DMA - 1) / TW_DMA, H / th, B);
    conv_halo<T, TW_DMA><<<grid, THREADS, bytes, stream>>>(x, k, out, B, H,
                                                           W, th);
    return cudaGetLastError();
  }
  const size_t bytes = KFRAG * sizeof(float4) +
                       2 * (size_t)(th + 2) * (TW_DB + 2) * C * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      conv_halo_db<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((W + TW_DB - 1) / TW_DB, B, (H / th + TILES_DB - 1) / TILES_DB);
  conv_halo_db<T><<<grid, THREADS, bytes, stream>>>(x, k, out, B, H, W, th);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, H, W, 16) contiguous, 16-byte aligned, float32 (x_bf16 = 0) or
// bfloat16 (x_bf16 = 1); k: (3, 3, 16, 16) float32 contiguous; out:
// (B, H, W, 16) float32. H % tile_h == 0 for variants 1 and 2. Launches on
// ``stream`` and returns cudaGetLastError() (0 = launched).
int conv3x3_p8_launch(int variant, const void* x, int x_bf16, const float* k,
                      float* out, int B, int H, int W, int tile_h,
                      void* stream) {
  if (variant < 0 || variant > 2 || tile_h <= 0 || H % tile_h != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      x_bf16 ? launch<__nv_bfloat16>(variant, x, k, out, B, H, W, tile_h, s)
             : launch<float>(variant, x, k, out, B, H, W, tile_h, s);
  return (int)e;
}

const char* conv3x3_p8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
