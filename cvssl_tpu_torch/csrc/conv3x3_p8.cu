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
// device memory is translated here, not its blocks. All three multiply on
// the tensor cores with one inner loop (mma_rows, below); they differ in
// where its A operand comes from:
//
//   0: straight from device memory, through the read-only path: no
//      shifted views and no shared-memory tile. SAME padding and the
//      ragged last strip are predicated loads of zero; L1 serves the three
//      dw shifts and the rows that neighbouring output rows share.
//   1: a block copies one (tile_h+2) x (TW+2) x 16 halo tile of one column
//      strip into shared memory once with cp.async (zero-filled outside
//      the image) while it splits the weights, then computes the tile.
//   2: the same kernel template with TILES_DB row tiles a block, walked in
//      a loop (the TPU's sequential grid axis): a two-stage cp.async ring
//      prefetches tile t+1 while the block computes tile t.
//
// VMEM held the whole padded row span ((tile_h+8) x (W+16) x 64 B, ~696 KB
// at W = 256); a Hopper block has at most 227 KB of shared memory, so the
// tile kernels also tile W (TW = 16 columns). The TPU's 7 bottom pad rows
// served sublane alignment only and are gone.
//
// Arithmetic: split TF32 on the tensor cores. Each output row of 16 pixels
// of a strip is an M = 16 tile, the 16 output channels two N = 8 tiles,
// and each tap's 16 input channels two K = 8 steps of mma.sync.m16n8k8
// .tf32 with f32 accumulators. One TF32 product keeps 11 significant bits,
// about 3e-4 of the largest output, far outside the port's 1e-5 gate. So
// every operand is split as v = hi + lo, hi = tf32(v) (round to nearest,
// ties away), and f32 input takes three products, lo(x) hi(k) + hi(x)
// lo(k) + hi(x) hi(k), whose terms alone are within 1e-7 of the largest
// output; a bfloat16 input is exact in TF32, so it takes two, x lo(k) +
// x hi(k). The weights are split once per block. The tensor cores' float32
// sums (54 products deep for f32 input) bring the error to about 1.5e-6 of
// the largest output on an H100. The JAX kernels in interpret mode compute
// in true f32; the TPU's single-pass bf16 MXU products are not copied.
//
// Bound (H100 SXM, 3.35 TB/s, 495 TFLOP/s dense TF32): at (24, 256, 256,
// 16) the f32 input + f32 output is 201,335,808 B (60.1 us; 45.1 us with
// bf16 input) and the conv is 7.25 GFLOP (14.6 us on the tensor cores), so
// the work is bound by bytes. The kernels issue 3 (f32) or 2 (bf16)
// mma.sync per product, 21.7 or 14.5 GFLOP: at the dense TF32 rate 44 or
// 29 us, under the bytes, but mma.sync alone reaches about 300 TFLOP/s on
// an H100 (chip_conv_variants.py --mma-rate), so the products take about
// 75 or 50 us, and they overlap the memory traffic only in part (the
// kernels' skeletons in chip_conv_variants.py add up to their times).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (done by cvssl_tpu_torch/ops/conv3x3_p8.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 16;                 // input = output channels
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TW = 16;                // strip width (pixels) = M
constexpr int R_DB = 2;               // output rows per warp
constexpr int TILES_DB = 2;           // row tiles per block, variant 2
constexpr int TILES_DIRECT = 4;       // row tiles per block, variant 0
// the weights as split-TF32 B fragments: 9 taps x 4 (k-step, n-tile) x 32
// lanes x float4
constexpr int KFRAG = 9 * 4 * 32;

// ---------------------------------------------------------------------------
// cp.async halo tiles (variants 1 and 2)
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
template <typename T>
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

// ---------------------------------------------------------------------------
// split-TF32 implicit GEMM on the tensor cores (all variants)
// ---------------------------------------------------------------------------
// Fragments of mma.m16n8k8 .tf32 (lane = 4 g + t): A (16 x 8) a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8) b0 (t, g),
// b1 (t + 4, g); D (16 x 8) d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t),
// d3 (g + 8, 2t + 1). Rows of A are pixels, columns of D output channels.
// K runs over input channels in the order that lets one 16-byte load give a
// lane its A values of both k-steps: in k-step s, k = t is channel
// 4t + 2s and k = t + 4 channel 4t + 2s + 1. A warp's load of 8 pixels x 16
// channels is then one contiguous 512-byte run, of shared memory (free of
// bank conflicts without padding the pixel stride) or of NHWC device
// memory (coalesced without staging).

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

// One lane's A values of one pixel, channels 4t .. 4t+3: 16 bytes of
// float32 or 8 of bfloat16.
template <typename T> struct AVec { using type = float4; };
template <> struct AVec<__nv_bfloat16> { using type = uint2; };

// A values as TF32 hi and lo parts (float32 input). lo = v - hi is exact
// in float32 and goes to the tensor cores as it is: they read a TF32
// operand's top 19 bits, so lo is cut to TF32 there (an error of at most
// 2^-21 |v|), which saves rounding it here ...
__device__ __forceinline__ void split_a(const float4 v, uint32_t hi[4],
                                        uint32_t lo[4]) {
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(f[i]);
    lo[i] = __float_as_uint(f[i] - __uint_as_float(hi[i]));
  }
}

// ... or exactly (bfloat16 input: its 8 mantissa bits fit TF32's 10; lo
// is 0 and unused)
__device__ __forceinline__ void split_a(const uint2 v, uint32_t hi[4],
                                        uint32_t lo[4]) {
  hi[0] = v.x << 16;
  hi[1] = v.x & 0xffff0000u;
  hi[2] = v.y << 16;
  hi[3] = v.y & 0xffff0000u;
#pragma unroll
  for (int i = 0; i < 4; ++i) lo[i] = 0u;
}

// Where a warp's A values come from: src(i, dw, half) is this lane's
// vector of input row i of the warp's rows (image row = first output row
// + i - 1) at image column col0 + g + 8 half + dw - 1.
//
// AHEAD: whether a load is issued a step (dw, input row) ahead of the
// products that use it.
//
// Variants 1 and 2: the halo tile in shared memory; its loads are short,
// so each is issued where it is used.
template <typename T>
struct TileA {
  using V = typename AVec<T>::type;
  static constexpr bool AHEAD = false;
  const T* px;  // tile + (top input row * (TW + 2) + g) * C + 4t
  __device__ __forceinline__ V operator()(int i, int dw, int half) const {
    return *reinterpret_cast<const V*>(px +
                                       (i * (TW + 2) + dw + 8 * half) * C);
  }
};

// Variant 0: the input in device memory, read through the read-only path
// (ld.global.nc); a pixel outside the image reads as zero (SAME padding,
// and the columns past W of a ragged last strip). An L1 or L2 round trip
// is long, so each load is issued a step ahead of the products that use
// it.
template <typename T>
struct GlobalA {
  using V = typename AVec<T>::type;
  static constexpr bool AHEAD = true;
  const T* img;  // image b + 4t
  int h0, w0;    // image row of input row 0; image column of g at dw = 0
  int H, W;
  __device__ __forceinline__ V operator()(int i, int dw, int half) const {
    const int h = h0 + i, w = w0 + dw + 8 * half;
    V v = {};
    if (h >= 0 && h < H && w >= 0 && w < W)
      v = __ldg(reinterpret_cast<const V*>(img + (h * W + w) * C));
    return v;
  }
};

// Output rows orow .. orow+NR-1 of one 16-pixel strip, by one warp: for
// each dw, the B fragments of the three dh taps stay in registers while
// the warp walks the NR + 2 input rows, and each input row's A fragment,
// loaded and split once, feeds every output row it reaches (dh = input row
// - output row).
template <typename T, int NR, typename Src>
__device__ __forceinline__ void mma_rows(const Src& src, const float4* wfrag,
                                         float* __restrict__ out, long long b,
                                         int orow, int col0, int H, int W) {
  using V = typename AVec<T>::type;
  constexpr bool SPLIT_A = sizeof(T) == sizeof(float);
  constexpr int NI = NR + 2;  // input rows
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[NR][2][4];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.f;
  // pixels g and g + 8 of the next step (dw, input row), when the source
  // loads ahead
  V nxt0 = {}, nxt8 = {};
  if constexpr (Src::AHEAD) {
    nxt0 = src(0, 0, 0);
    nxt8 = src(0, 0, 1);
  }
#pragma unroll
  for (int dw = 0; dw < 3; ++dw) {
    float4 bw[3][4];
#pragma unroll
    for (int dh = 0; dh < 3; ++dh)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bw[dh][j] = wfrag[((dh * 3 + dw) * 4 + j) * 32 + lane];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      V a0, a8;
      if constexpr (Src::AHEAD) {
        a0 = nxt0;
        a8 = nxt8;
        const int next = dw * NI + i + 1;
        if (next < 3 * NI) {
          nxt0 = src(next % NI, next / NI, 0);
          nxt8 = src(next % NI, next / NI, 1);
        }
      } else {
        a0 = src(i, dw, 0);
        a8 = src(i, dw, 1);
      }
      uint32_t hi0[4], lo0[4], hi8[4], lo8[4];  // pixels g and g + 8
      split_a(a0, hi0, lo0);
      split_a(a8, hi8, lo8);
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
    float* row = out + ((b * H + orow + r) * W) * C;
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

// ---------------------------------------------------------------------------
// variants 1 and 2: halo tiles in shared memory
// ---------------------------------------------------------------------------
// grid (strips, B, ceil(nt / TILES)), nt = H / th: block (x, b, z) computes
// row tiles z * TILES .. (at most TILES, fewer at the end) of strip x of
// image b; each warp takes groups of R_DB output rows of a tile. TILES = 1
// (variant 1) copies its one tile while it splits the weights (copying the
// rows of the warps' first pass in a cp.async group of their own, to start
// on them sooner, was slower: chip_conv_variants.py). TILES_DB = 2 (variant
// 2) measured fastest at (24, 256, 256, 16): the ring overlaps the second
// tile's copy with the first's products, and the many short blocks keep
// every SM's two slots busy (one tile a block, or four or eight, was
// slower).
template <typename T, int TILES>
__global__ void __launch_bounds__(THREADS, 2)
conv_halo(const T* __restrict__ x, const float* __restrict__ k,
          float* __restrict__ out, int B, int H, int W, int th) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* wfrag = reinterpret_cast<float4*>(smem);
  T* ring = reinterpret_cast<T*>(smem + KFRAG * sizeof(float4));
  const int stage = (th + 2) * (TW + 2) * C;  // elements per ring slot
  const int col0 = blockIdx.x * TW;
  const long long b = blockIdx.y;
  const int t0 = blockIdx.z * TILES, per = min(TILES, H / th - t0);
  const int groups = (th + R_DB - 1) / R_DB;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  issue_tile<T>(x, ring, b, t0 * th, col0, th, H, W);
  cp_async_commit();
  load_weights_tf32(k, wfrag);
  for (int u = 0; u < per; ++u) {
    if (u + 1 < per) {
      // slot (u+1)&1 was last read in iteration u-1, which ended in a
      // barrier, so it is free
      issue_tile<T>(x, ring + ((u + 1) & 1) * stage, b, (t0 + u + 1) * th,
                    col0, th, H, W);
      cp_async_commit();
      cp_async_wait<1>();  // tile u has landed; u+1 stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tile = ring + (u & 1) * stage;
    const int row0 = (t0 + u) * th;
    for (int q = warp; q < groups; q += WARPS) {
      const int o0 = q * R_DB, nr = min(R_DB, th - o0);
      const T* px = tile + (o0 * (TW + 2) + g) * C + 4 * t;
      if (nr == R_DB)
        mma_rows<T, R_DB>(TileA<T>{px}, wfrag, out, b, row0 + o0, col0, H,
                          W);
      else  // the short last group of a tile_h that R_DB does not divide
        for (int r = 0; r < nr; ++r)
          mma_rows<T, 1>(TileA<T>{px + r * (TW + 2) * C}, wfrag, out, b,
                         row0 + o0 + r, col0, H, W);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// variant 0: A fragments straight from device memory
// ---------------------------------------------------------------------------
// grid (strips, B, ceil(nt / TILES_DIRECT)): block (x, b, z) computes the
// rows of row tiles z * TILES_DIRECT .. of strip x of image b, in groups of
// R_DB rows a warp; neighbouring warps take neighbouring groups, so the
// input rows they share are in L1 together. Shared memory holds only the
// split weights (18 KB). Four tiles a block (128 rows at tile_h 32)
// measured fastest at (24, 256, 256, 16): fewer blocks split the weights,
// and 768 blocks still fill the 264 slots of an H100 nearly three times (one,
// two or eight tiles were slower: chip_conv_variants.py).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
conv_direct(const T* __restrict__ x, const float* __restrict__ k,
            float* __restrict__ out, int B, int H, int W, int th) {
  __shared__ float4 wfrag[KFRAG];
  const int col0 = blockIdx.x * TW;
  const long long b = blockIdx.y;
  const int row0 = blockIdx.z * TILES_DIRECT * th;
  const int rows = min(TILES_DIRECT * th, H - row0);
  const int groups = (rows + R_DB - 1) / R_DB;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  load_weights_tf32(k, wfrag);
  __syncthreads();
  const T* img = x + b * H * W * C + 4 * t;
  for (int q = warp; q < groups; q += WARPS) {
    const int o = row0 + q * R_DB, nr = min(R_DB, rows - q * R_DB);
    if (nr == R_DB)
      mma_rows<T, R_DB>(GlobalA<T>{img, o - 1, col0 + g - 1, H, W}, wfrag,
                        out, b, o, col0, H, W);
    else  // the short last group of a row count that R_DB does not divide
      for (int r = 0; r < nr; ++r)
        mma_rows<T, 1>(GlobalA<T>{img, o + r - 1, col0 + g - 1, H, W},
                       wfrag, out, b, o + r, col0, H, W);
  }
}

template <typename T, int TILES>
cudaError_t launch_halo(const T* x, const float* k, float* out, int B, int H,
                        int W, int th, cudaStream_t stream) {
  const int stages = TILES > 1 ? 2 : 1;
  const size_t bytes = KFRAG * sizeof(float4) +
                       stages * (size_t)(th + 2) * (TW + 2) * C * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      conv_halo<T, TILES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((W + TW - 1) / TW, B, (H / th + TILES - 1) / TILES);
  conv_halo<T, TILES><<<grid, THREADS, bytes, stream>>>(x, k, out, B, H, W,
                                                        th);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int variant, const void* xv, const float* k, float* out,
                   int B, int H, int W, int th, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  if (variant == 1) return launch_halo<T, 1>(x, k, out, B, H, W, th, stream);
  if (variant == 2)
    return launch_halo<T, TILES_DB>(x, k, out, B, H, W, th, stream);
  dim3 grid((W + TW - 1) / TW, B,
            (H / th + TILES_DIRECT - 1) / TILES_DIRECT);
  conv_direct<T><<<grid, THREADS, 0, stream>>>(x, k, out, B, H, W, th);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, H, W, 16) contiguous, 16-byte aligned, float32 (x_bf16 = 0) or
// bfloat16 (x_bf16 = 1); k: (3, 3, 16, 16) float32 contiguous; out:
// (B, H, W, 16) float32. H % tile_h == 0. Launches on ``stream`` and
// returns cudaGetLastError() (0 = launched).
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
