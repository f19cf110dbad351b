// 3x3 / stride 1 / zero-padding 1 convolution, NHWC in and out, for the
// full-resolution row of UNet++ on Hopper (sm_90a). Replaces the Pallas
// kernel tactile_gan_tpu/ops/pallas/conv3x3.py conv3x3_packed (_kernel_packed,
// with _build_b): its packed (N, H*W/2, 2C) operand is NHWC memory, so here
// it is a plain channels-last conv. The 12-tap B-matrix embedding existed to
// fill the TPU's 128 MXU lanes and is not carried over.
//
// Bound: operations. At the serving shapes (256x256, Cin 64..384, Co 64) the
// function does 2*9*Cin*64 flops per pixel against (Cin + 64) * itemsize
// bytes, near or above the card's ~295 flop/byte ridge for bf16, so the
// least time is about flops / 989 TFLOP/s (bf16 tensor cores) or / 67
// TFLOP/s (float32 compute on the CUDA cores), or the bytes over 3.35 TB/s
// where the input is float32 and Cin small.
//
// Design (an implicit GEMM: M = output pixels, N = Co, K = 9 taps x Cin):
//  * bf16 compute: a block of 8 warps computes an 8 x 32 tile of output
//    pixels x all Co channels; each warp owns one output row of 32 pixels
//    (two m16 tiles) x Co (Co/8 n8 tiles) in float32 registers and issues
//    mma.sync m16n8k16 bf16 products, its operands read from shared memory
//    with ldmatrix.
//  * Cin is walked in 16-channel slices through a two-stage ring in shared
//    memory: while the tensor cores work on slice s, the 10 x 34 haloed
//    input tile and the 9 x Co x 16 weight slice of slice s+1 are in flight
//    (cp.async for bf16 data; float32 input is loaded into registers and
//    rounded to bf16 on its way into shared memory). Zero padding is the
//    zero fill of out-of-image halo pixels.
//  * Each pixel's 16 channels (32 bytes) are two 16-byte chunks whose order
//    is swapped on every other group of four pixels (and weight rows), so the
//    eight rows of each ldmatrix phase fall in distinct banks.
//  * float32 compute: the CUDA cores (one pixel x Co/2 channels per thread,
//    FMA in float32) over an 8 x 16 tile.
//  * The output dtype follows the input dtype; accumulation is float32.
//  * Weights arrive pre-laid by the wrapper: [9][Co][Cin_pad] bf16 (Cin_pad a
//    multiple of 16, zero-filled) for bf16 compute, [9][Cin][Co] float32
//    otherwise. Cin must be a multiple of 8 and Co one of 16, 32, 64.
// Left for later work: wgmma/TMA, a persistent grid, deeper pipelines.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps

// bf16 tensor-core path.
constexpr int kMH = 8, kMW = 32;              // output tile
constexpr int kHH = kMH + 2, kHW = kMW + 2;   // haloed input tile
constexpr int kHaloPix = kHH * kHW;
constexpr int kKC = 16;                       // Cin slice
constexpr int kXUnits = kHaloPix * 2;         // 16-byte units of a halo slice
constexpr int kXPerThread = (kXUnits + kThreads - 1) / kThreads;

// float32 CUDA-core path.
constexpr int kTH = 8, kTW = 16;              // output tile
constexpr int kIH = kTH + 2, kIW = kTW + 2;   // haloed input tile
constexpr int kKCF = 8;                       // Cin slice
constexpr int kKCFP = kKCF + 1;               // padded pixel stride

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset of 16-byte chunk `c` (0 or 1) of 32-byte row `row`.
__device__ __forceinline__ int swz(int row, int c) {
  return row * kKC + 8 * (c ^ ((row >> 2) & 1));
}

__device__ __forceinline__ uint4 pack8_bf16(const float4 a, const float4 b) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(a.x, a.y);
  h[1] = __floats2bfloat162_rn(a.z, a.w);
  h[2] = __floats2bfloat162_rn(b.x, b.y);
  h[3] = __floats2bfloat162_rn(b.z, b.w);
  return raw;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// bf16 operands, float32 accumulation (tensor cores through mma.sync).
// Dynamic shared memory: two stages of [halo pixels][16] + [9 * CO][16] bf16.
template <typename T, int CO>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_bf16_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    T* __restrict__ y, int h, int wd, int cin, int cin_pad) {
  constexpr int kNT = CO / 8;                  // n8 tiles
  constexpr int kXElems = kHaloPix * kKC;
  constexpr int kWElems = 9 * CO * kKC;
  constexpr int kStage = kXElems + kWElems;
  constexpr int kWUnits = 9 * CO * 2;
  constexpr bool kF32In = sizeof(T) == 4;
  extern __shared__ __align__(128) __nv_bfloat16 smem[];

  const int w0 = blockIdx.x * kMW, h0 = blockIdx.y * kMH, img = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* ximg = x + (size_t)img * h * wd * cin;
  const int slices = cin_pad / kKC;

  // Input units of this thread: (halo pixel, chunk), its source or null.
  const T* xsrc[kXPerThread];
  int xdst[kXPerThread];
#pragma unroll
  for (int k = 0; k < kXPerThread; ++k) {
    const int u = threadIdx.x + k * kThreads;
    xsrc[k] = nullptr;
    xdst[k] = -1;
    if (u < kXUnits) {
      const int pix = u >> 1, c = u & 1;
      const int ih = h0 - 1 + pix / kHW, iw = w0 - 1 + pix % kHW;
      xdst[k] = swz(pix, c);
      if (ih >= 0 && ih < h && iw >= 0 && iw < wd)
        xsrc[k] = ximg + ((size_t)ih * wd + iw) * cin + c * 8;
    }
  }

  float4 xreg[kXPerThread][2];  // float32 input in flight (kF32In only)

  auto issue_weights = [&](int s, __nv_bfloat16* ws) {
    const int c0 = s * kKC;
    for (int u = threadIdx.x; u < kWUnits; u += kThreads) {
      const int row = u >> 1, c = u & 1;  // row = tap * CO + co
      cp_async16(ws + swz(row, c), w + (size_t)row * cin_pad + c0 + c * 8, 16);
    }
  };
  auto issue_input = [&](int s, __nv_bfloat16* xs) {
    const int c0 = s * kKC;
    const bool ch_ok = c0 + (threadIdx.x & 1) * 8 < cin;  // this unit's chunk
#pragma unroll
    for (int k = 0; k < kXPerThread; ++k) {
      if (xdst[k] < 0) continue;
      const bool ok = xsrc[k] != nullptr && ch_ok;
      if constexpr (kF32In) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        xreg[k][0] = xreg[k][1] = z;
        if (ok) {
          const float4* p = reinterpret_cast<const float4*>(xsrc[k] + c0);
          xreg[k][0] = p[0];
          xreg[k][1] = p[1];
        }
      } else {
        cp_async16(xs + xdst[k], ok ? (const void*)(xsrc[k] + c0) : (const void*)x,
                   ok ? 16 : 0);
      }
    }
  };
  auto store_input = [&](__nv_bfloat16* xs) {
    if constexpr (kF32In) {
#pragma unroll
      for (int k = 0; k < kXPerThread; ++k)
        if (xdst[k] >= 0)
          *reinterpret_cast<uint4*>(xs + xdst[k]) =
              pack8_bf16(xreg[k][0], xreg[k][1]);
    }
  };

  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Prologue: slice 0 into stage 0.
  issue_input(0, smem);
  store_input(smem);
  issue_weights(0, smem + kXElems);
  cp_async_commit();

  // ldmatrix lane roles. A (16 pixels x 16 channels): row = lane % 16,
  // chunk = lane / 16. B (two n8 tiles x 16 channels): tile = (lane / 16),
  // row = lane % 8, chunk = (lane / 8) % 2.
  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int b_tile = lane >> 4, b_row = lane & 7, b_chunk = (lane >> 3) & 1;

  for (int s = 0; s < slices; ++s) {
    __nv_bfloat16* xs = smem + (s & 1) * kStage;
    __nv_bfloat16* ws = xs + kXElems;
    __nv_bfloat16* xn = smem + ((s + 1) & 1) * kStage;
    const bool more = s + 1 < slices;
    if (more) {
      issue_input(s + 1, xn);
      issue_weights(s + 1, xn + kXElems);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dh = tap / 3, dw = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int pix = (warp + dh) * kHW + i * 16 + dw + a_row;
        ldmatrix_x4(a[i], xs + swz(pix, a_chunk));
      }
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t b[4];
        const int row = tap * CO + (j + b_tile) * 8 + b_row;
        ldmatrix_x4(b, ws + swz(row, b_chunk));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][j], a[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
    if (more) store_input(xn);
    __syncthreads();
  }

  // Accumulator (m16n8): lane holds rows lane/4 and lane/4 + 8, columns
  // 2 * (lane % 4) and +1 of its tile.
  const int oh = h0 + warp;
  if (oh >= h) return;
  const int g = lane >> 2, cc = 2 * (lane & 3);
  T* yrow = y + ((size_t)img * h + oh) * wd * CO;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ow = w0 + i * 16 + g + half * 8;
      if (ow >= wd) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        store2(yrow + (size_t)ow * CO + j * 8 + cc, acc[i][j][2 * half],
               acc[i][j][2 * half + 1]);
    }
  }
}

__device__ __forceinline__ void load4_f32(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4_f32(const __nv_bfloat16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// float32 operands and accumulation on the CUDA cores.
template <typename T, int CO>
__global__ void __launch_bounds__(kThreads)
conv3x3_f32_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ y, int h, int wd, int cin) {
  constexpr int kCH = CO / 2;  // output channels per thread
  __shared__ float xs[kIH * kIW * kKCFP];
  __shared__ __align__(16) float ws[9 * kKCF * CO];

  const int w0 = blockIdx.x * kTW, h0 = blockIdx.y * kTH, img = blockIdx.z;
  const int p = threadIdx.x & 127, part = threadIdx.x >> 7;
  const int ph = p / kTW, pw = p % kTW;

  float acc[kCH];
#pragma unroll
  for (int k = 0; k < kCH; ++k) acc[k] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kKCF) {
    for (int u = threadIdx.x; u < kIH * kIW * 2; u += kThreads) {
      const int pix = u >> 1, grp = u & 1;
      const int ih = h0 - 1 + pix / kIW, iw = w0 - 1 + pix % kIW;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (ih >= 0 && ih < h && iw >= 0 && iw < wd)
        load4_f32(x + (((size_t)img * h + ih) * wd + iw) * cin + c0 + grp * 4, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) xs[pix * kKCFP + grp * 4 + i] = v[i];
    }
    constexpr int kWUnits = 9 * kKCF * CO / 4;
    for (int u = threadIdx.x; u < kWUnits; u += kThreads) {
      const int tap = u / (kKCF * CO / 4), r = u % (kKCF * CO / 4);
      reinterpret_cast<float4*>(ws)[u] = reinterpret_cast<const float4*>(
          w + ((size_t)tap * cin + c0) * CO)[r];
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* xp = xs + ((ph + tap / 3) * kIW + pw + tap % 3) * kKCFP;
#pragma unroll
      for (int ci = 0; ci < kKCF; ++ci) {
        const float xv = xp[ci];
        const float* wp = ws + (tap * kKCF + ci) * CO + part * kCH;
#pragma unroll
        for (int k = 0; k < kCH; ++k) acc[k] = fmaf(xv, wp[k], acc[k]);
      }
    }
    __syncthreads();
  }

  const int oh = h0 + ph, ow = w0 + pw;
  if (oh < h && ow < wd) {
    T* out = y + (((size_t)img * h + oh) * wd + ow) * CO + part * kCH;
#pragma unroll
    for (int k = 0; k < kCH; k += 4) store4(out + k, acc + k);
  }
}

template <typename T, int CO>
int launch(const void* x, const void* w, void* y, int n, int h, int wd,
           int cin, int cin_pad, int compute_bf16, cudaStream_t stream) {
  if (compute_bf16) {
    constexpr int kBytes = 2 * (kHaloPix + 9 * CO) * kKC * 2;
    static bool configured = false;  // the attribute is per kernel instance
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          conv3x3_bf16_kernel<T, CO>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
      if (err != cudaSuccess) return (int)err;
      configured = true;
    }
    const dim3 grid((wd + kMW - 1) / kMW, (h + kMH - 1) / kMH, n);
    conv3x3_bf16_kernel<T, CO><<<grid, kThreads, kBytes, stream>>>(
        static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<T*>(y), h, wd, cin, cin_pad);
  } else {
    const dim3 grid((wd + kTW - 1) / kTW, (h + kTH - 1) / kTH, n);
    conv3x3_f32_kernel<T, CO><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<T*>(y), h, wd, cin);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_co(const void* x, const void* w, void* y, int n, int h, int wd,
                int cin, int cin_pad, int co, int compute_bf16,
                cudaStream_t stream) {
  switch (co) {
    case 16: return launch<T, 16>(x, w, y, n, h, wd, cin, cin_pad, compute_bf16, stream);
    case 32: return launch<T, 32>(x, w, y, n, h, wd, cin, cin_pad, compute_bf16, stream);
    case 64: return launch<T, 64>(x, w, y, n, h, wd, cin, cin_pad, compute_bf16, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (N, H, W, Cin) in_dtype (0 float32, 1 bfloat16); y: (N, H, W, Co) of the
// same dtype. w: [9][Co][cin_pad] bfloat16 when compute_bf16 is 1 (cin_pad a
// multiple of 16), else [9][Cin][Co] float32 (cin_pad == Cin). Returns
// cudaGetLastError().
extern "C" int conv3x3_forward(const void* x, const void* w, void* y, int n,
                               int h, int wd, int cin, int cin_pad, int co,
                               int in_dtype, int compute_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1)
    return dispatch_co<__nv_bfloat16>(x, w, y, n, h, wd, cin, cin_pad, co,
                                      compute_bf16, s);
  return dispatch_co<float>(x, w, y, n, h, wd, cin, cin_pad, co, compute_bf16, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
