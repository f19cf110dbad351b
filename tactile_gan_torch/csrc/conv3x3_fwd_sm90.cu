// Kernel B's forward at Co = 64 with bf16 operands, on Hopper's warpgroup
// matrix multiply (wgmma, sm_90a): the 3x3 / stride 1 / zero-padding 1
// convolution of the full-resolution row of UNet++, NHWC in and out.
// Replaces the forward of the Pallas kernel
// tactile_gan_tpu/ops/pallas/conv3x3.py conv3x3_packed (_kernel_packed); its
// packed (N, H*W/2, 2C) operand is NHWC memory, so here it is a plain
// channels-last conv. The other uses of B (Co 16/32, float32 compute, widths
// off Cin % 8 == 0 and Co 16/32/64), B-dx and kernel E keep the mma.sync
// body of conv3x3.cu.
//
// y (N, H, W, 64) = conv(x (N, H, W, Cin)), Cin a multiple of 8, x float32 or
// bfloat16, operands rounded to bf16, float32 sums, y in x's dtype; any
// H, W >= 1.
//
// Bound: bytes where x is float32 (the main path: (Cin + 64) * 4 bytes a
// pixel against 2 * 9 * Cin * 64 flops, under the card's ~295 flop/byte bf16
// ridge at every Cin of the row), operations at the larger Cin with a bf16
// input: the least time is the larger of bytes / 3.35 TB/s and
// flops / 989 TFLOP/s.
//
// Design (an implicit GEMM: M = 64 consecutive output pixels of one row,
// N = Co = 64, K = 16 channels of one tap):
//  * A block of two warpgroups (256 threads) owns a 4 x 64 output tile and
//    all 64 channels; warpgroup g owns output rows 2g and 2g + 1, two
//    m64n64 float32 accumulators (2 x 32 registers a thread).
//  * Cin is walked in 16-channel slices through two stages of shared memory.
//    A stage holds the 6 x 66 haloed input tile as two chunk planes
//    [chunk 0|1][halo pixel][8 bf16] and the slice's weights as
//    [9 taps][chunk 0|1][64 co][8 bf16]. In wgmma's K-major layout without
//    swizzle a core matrix is 8 rows of 16 bytes, contiguous: any 8
//    consecutive pixels of a halo row are one, so the A operand of tap
//    (dh, dw) for output row r starts at halo pixel (r + dh) * 66 + dw and
//    the tile is written once a slice and read by all 9 taps. Leading byte
//    offset = the distance between the two chunk planes (K), stride byte
//    offset = 128 bytes (the next 8 rows). Each warpgroup issues 9 taps x 2
//    rows = 18 products a slice, all from shared memory.
//  * While the products of slice s run (wgmma is asynchronous), the threads
//    load slice s + 1 into the other stage: a float32 input through
//    registers, rounded to bf16 on its way (TMA could not round), a bf16
//    input and the weights by cp.async. Then cp.async.wait_all,
//    fence.proxy.async (the generic-proxy writes become visible to wgmma's
//    async proxy), wgmma.wait_group 0 and __syncthreads. Out-of-image halo
//    pixels and channels past Cin are zero-filled.
//  * The weights arrive pre-laid by the wrapper as [slices][9][2][64][8]
//    bf16 (Cin zero-padded to a multiple of 16), so a stage's weights are
//    one contiguous 18,432-byte copy.
// Built with ptxas -O1 (SOURCE_FLAGS in ops/kernels/build.py): ptxas of
// CUDA 12.9 segfaults on this source at -O3 and -O2, triggered by the
// fence.proxy.async that the kernel needs.
// Left for later work: a deeper ring, warp specialisation, a persistent grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                  // two warpgroups
constexpr int kRows = 4, kCols = 64;           // output tile
constexpr int kCo = 64;
constexpr int kHaloW = kCols + 2;
constexpr int kHaloPix = (kRows + 2) * kHaloW;  // 396
constexpr int kKC = 16;                        // Cin slice
constexpr int kPlaneBytes = kHaloPix * 16;     // one chunk plane
constexpr int kXBytes = 2 * kPlaneBytes;       // 12,672
constexpr int kTapBytes = 2 * kCo * 16;        // one tap's two chunk planes
constexpr int kWBytes = 9 * kTapBytes;         // 18,432
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kSmemBytes = 2 * kStageBytes;    // 62,208
constexpr int kXUnits = kHaloPix * 2;          // 16-byte units of a halo slice
constexpr int kXPerThread = (kXUnits + kThreads - 1) / kThreads;
constexpr int kWUnits = kWBytes / 16;
static_assert(kXBytes % 128 == 0 && kWBytes % 128 == 0, "stage alignment");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
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

// Shared-memory matrix descriptor, K-major without swizzle (layout type 0):
// start address, leading byte offset (between the core matrices adjacent
// in K) and stride byte offset (between 8-row groups), each in 16-byte
// units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// d (64 x 64, float32) += a (64 x 16) * b (64 x 16)^T, both bf16 in shared
// memory through their descriptors.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_fwd_sm90_kernel(const T* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        T* __restrict__ y, int h, int wd, int cin,
                        int slices) {
  constexpr bool kF32In = sizeof(T) == 4;
  extern __shared__ __align__(128) uint8_t smem[];
  const int w0 = blockIdx.x * kCols, h0 = blockIdx.y * kRows;
  const int img = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const T* ximg = x + (size_t)img * h * wd * cin;

  // This thread's input units (halo pixel u / 2, chunk u % 2): the element
  // offset of the chunk in the image, -1 outside the image or past the
  // tile's units.
  int xoff[kXPerThread];
#pragma unroll
  for (int k = 0; k < kXPerThread; ++k) {
    const int u = threadIdx.x + k * kThreads;
    const int pix = u >> 1;
    const int ih = h0 - 1 + pix / kHaloW, iw = w0 - 1 + pix % kHaloW;
    xoff[k] = u < kXUnits && ih >= 0 && ih < h && iw >= 0 && iw < wd
                  ? (ih * wd + iw) * cin + (u & 1) * 8
                  : -1;
  }
  // The unit's chunk is threadIdx.x % 2 for every k (kThreads is even).
  const int chunk = threadIdx.x & 1;
  float4 xreg[kXPerThread][2];  // a float32 slice in flight

  auto load_input = [&](int s, uint8_t* xs) {
    const bool ch_ok = s * kKC + chunk * 8 < cin;
#pragma unroll
    for (int k = 0; k < kXPerThread; ++k) {
      const int u = threadIdx.x + k * kThreads;
      if (u >= kXUnits) continue;
      const bool ok = ch_ok && xoff[k] >= 0;
      if constexpr (kF32In) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        xreg[k][0] = xreg[k][1] = z;
        if (ok) {
          const float4* p =
              reinterpret_cast<const float4*>(ximg + xoff[k] + s * kKC);
          xreg[k][0] = p[0];
          xreg[k][1] = p[1];
        }
      } else {
        cp_async16(xs + chunk * kPlaneBytes + (u >> 1) * 16,
                   ok ? (const void*)(ximg + xoff[k] + s * kKC)
                      : (const void*)x,
                   ok ? 16 : 0);
      }
    }
  };
  auto store_input = [&](uint8_t* xs) {
    if constexpr (kF32In) {
#pragma unroll
      for (int k = 0; k < kXPerThread; ++k) {
        const int u = threadIdx.x + k * kThreads;
        if (u < kXUnits)
          *reinterpret_cast<uint4*>(xs + chunk * kPlaneBytes + (u >> 1) * 16) =
              pack8_bf16(xreg[k][0], xreg[k][1]);
      }
    }
  };
  auto load_weights = [&](int s, uint8_t* ws) {
    const uint4* src = reinterpret_cast<const uint4*>(w) + (size_t)s * kWUnits;
    for (int u = threadIdx.x; u < kWUnits; u += kThreads)
      cp_async16(ws + u * 16, src + u, 16);
  };
  auto publish = [&]() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  float acc[2][32];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[i][j] = 0.f;

  // Descriptors of stage 0: A at halo row 2 * wg (the warpgroup's first
  // output row, tap (0, 0)), B at tap 0. Offsets below are in 16-byte units:
  // one halo pixel, or one 16-byte weight row.
  const uint32_t base = smem_addr(smem);
  const uint64_t a_desc = make_desc(base + 2 * wg * kHaloW * 16, kPlaneBytes,
                                    128);
  const uint64_t b_desc = make_desc(base + kXBytes, kCo * 16, 128);

  // Prologue: slice 0 into stage 0.
  load_input(0, smem);
  load_weights(0, smem + kXBytes);
  store_input(smem);
  publish();
  __syncthreads();

  for (int s = 0; s < slices; ++s) {
    const uint64_t stage = (uint64_t)((s & 1) * (kStageBytes / 16));
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dh = tap / 3, dw = tap % 3;
      const uint64_t b = b_desc + stage + tap * (kTapBytes / 16);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        wgmma_m64n64k16(acc[r], a_desc + stage + (r + dh) * kHaloW + dw, b);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (s + 1 < slices) {
      uint8_t* next = smem + ((s + 1) & 1) * kStageBytes;
      load_input(s + 1, next);
      load_weights(s + 1, next + kXBytes);
      store_input(next);
    }
    publish();
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc[0]);
    fence_operands(acc[1]);
    __syncthreads();
  }

  // Accumulator (m64nN): warp q of the warpgroup holds rows 16q + lane / 4
  // and + 8, columns 8j + 2 (lane % 4) and + 1 of each n8 block j.
  const int q = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int cc = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int oh = h0 + 2 * wg + r;
    if (oh >= h) continue;
    T* yrow = y + ((size_t)img * h + oh) * wd * kCo;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ow = w0 + 16 * q + (lane >> 2) + 8 * half;
      if (ow >= wd) continue;
      T* p = yrow + (size_t)ow * kCo + cc;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2(p + 8 * j, acc[r][4 * j + 2 * half], acc[r][4 * j + 2 * half + 1]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int n, int h, int wd,
           int cin, int slices, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_fwd_sm90_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((wd + kCols - 1) / kCols, (h + kRows - 1) / kRows, n);
  conv3x3_fwd_sm90_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<T*>(y), h, wd, cin, slices);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, H, W, Cin) in_dtype (0 float32, 1 bfloat16), Cin a multiple of 8,
// 16-byte aligned; y: (N, H, W, 64) of the same dtype. w: [cin_pad / 16][9]
// [2][64][8] bfloat16, cin_pad = Cin rounded up to a multiple of 16, zero
// past Cin. Returns cudaGetLastError().
extern "C" int conv3x3_fwd_sm90(const void* x, const void* w, void* y, int n,
                                int h, int wd, int cin, int cin_pad,
                                int in_dtype, void* stream) {
  if (cin <= 0 || cin % 8 || cin_pad % kKC || cin_pad < cin ||
      cin_pad - cin >= kKC || n <= 0 || h <= 0 || wd <= 0 || n > 65535 ||
      (h + kRows - 1) / kRows > 65535 ||
      (long long)h * wd * cin >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slices = cin_pad / kKC;
  if (in_dtype == 1)
    return launch<__nv_bfloat16>(x, w, y, n, h, wd, cin, slices, s);
  return launch<float>(x, w, y, n, h, wd, cin, slices, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
