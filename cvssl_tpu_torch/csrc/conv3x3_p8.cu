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
//   2: a block walks the row tiles of one column strip of one image in a
//      loop (the TPU's sequential grid axis); a two-stage cp.async ring
//      prefetches tile t+1 while the block computes tile t.
//
// VMEM held the whole padded row span ((tile_h+8) x (W+16) x 64 B, ~696 KB
// at W = 256); a Hopper block has at most 227 KB of shared memory, so the
// tile kernels also tile W (TW columns). The TPU's 7 bottom pad rows served
// sublane alignment only and are gone.
//
// Arithmetic: float32 FMAs on the CUDA cores, bfloat16 inputs widened in
// registers, so results match the JAX kernels in interpret mode (true f32),
// not the TPU's single-pass bf16 MXU products.
//
// Bound (H100 SXM, 3.35 TB/s, 67 TFLOP/s f32): at (24, 256, 256, 16) the
// f32 input + f32 output is 201,335,808 B (60.1 us) and the conv is
// 7.25 GFLOP (108 us on CUDA cores), so these float32 kernels are bound by
// operations; a tensor-core design would be bound by bytes.
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
constexpr int TW_DB = 16;             // tile width (pixels), variant 2

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

template <typename T, int TW>
__global__ void __launch_bounds__(THREADS)
conv_halo_db(const T* __restrict__ x, const float* __restrict__ k,
             float* __restrict__ out, int B, int H, int W, int th) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* wsm = reinterpret_cast<float*>(smem);
  T* ring = reinterpret_cast<T*>(smem + KW * sizeof(float));
  const int stage = (th + 2) * (TW + 2) * C;  // elements per ring slot
  const int col0 = blockIdx.x * TW;
  const long long b = blockIdx.y;
  const int nt = H / th;
  issue_tile<T, TW>(x, ring, b, 0, col0, th, H, W);
  cp_async_commit();
  load_weights(k, wsm);
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      // slot (t+1)&1 was last read in iteration t-1, which ended in a
      // barrier, so it is free
      issue_tile<T, TW>(x, ring + ((t + 1) & 1) * stage, b, (t + 1) * th,
                        col0, th, H, W);
      cp_async_commit();
      cp_async_wait<1>();  // tile t has landed; t+1 stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute_tile<T, TW>(ring + (t & 1) * stage, wsm, out, b, t * th, col0,
                        th, H, W);
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
  const size_t bytes =
      wbytes + 2 * (size_t)(th + 2) * (TW_DB + 2) * C * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      conv_halo_db<T, TW_DB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((W + TW_DB - 1) / TW_DB, B);
  conv_halo_db<T, TW_DB><<<grid, THREADS, bytes, stream>>>(x, k, out, B, H,
                                                           W, th);
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
