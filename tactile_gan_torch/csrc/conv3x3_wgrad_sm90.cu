// Kernel D with bf16 operands on Hopper's warpgroup matrix multiply (wgmma,
// sm_90a): the weight gradient of the 3x3 / stride 1 / zero-padding 1
// convolution of the full-resolution row of UNet++, NHWC in, partial sums
// out. Replaces the Pallas kernel tactile_gan_tpu/ops/pallas/conv3x3.py
// conv3x3_packed_wgrad (_kernel_packed_wgrad) and its fold
// ops/packed_row.py _dk_from_db:
//   dk[co][ci][ky][kx] = sum_p x[p + (ky - 1, kx - 1)][ci] * g[p][co],
// x read as zero outside the image. The Pallas kernel sums A^T @ G over a
// sequential grid into one block; here the blocks run in parallel, so each
// writes its partial dk and wgrad_reduce_kernel (conv3x3_wgrad.cu, entry
// conv3x3_wgrad_reduce) sums them in a fixed order into OIHW float32: the
// result is the same on every run. The float32-compute case keeps
// wgrad_f32_kernel in conv3x3_wgrad.cu.
//
// x (N, H, W, Cin) and g (N, H, W, Co), both float32 or both bfloat16,
// rounded to bf16, float32 sums; Cin a multiple of 8, Co a multiple of 8 up
// to 64, any N, H, W >= 1.
//
// Bound: a GEMM with M = 9 * Cin, N = Co and K = N*H*W pixels. At float32
// inputs (the training step) the bytes bound it: (Cin + Co) * 4 bytes a
// pixel against 2 * 9 * Cin * Co flops, under the card's ~295 flop/byte
// bf16 ridge at every Cin of the row, so the least time is about
// N*H*W * (Cin + 64) * 4 B / 3.35 TB/s. The design therefore reads x and g
// from device memory about once and keeps the loads in flight while the
// products run.
//
// Design (per tap, M = 64 input channels, N = 64 output channels, K = 16
// pixels of one row):
//  * A block of three warpgroups (384 threads) owns one ci tile of 64
//    channels, all 64 output channels and a run of (strip, output row)
//    pairs; a strip is 64 columns of one image. Warpgroup dh owns the taps
//    (dh, 0..2): three m64n64 float32 accumulators, 96 registers a thread.
//    All 9 taps of a ci tile stay in one block, so g is read once per ci
//    tile.
//  * Shared memory is a rolling ring of rows: 4 input rows of 66 haloed
//    pixels (one slot is filled while three are read) and 2 g rows of 64
//    pixels, each stored pixel-major as 8 chunk planes [chunk][pixel][8
//    bf16]. Both wgmma operands are MN-major (transpose flags 1, 1): 8
//    consecutive pixels of one plane are 128 contiguous bytes, one core
//    matrix whose rows are K (pixels) and whose 16 bytes are 8 channels. Tap
//    (dh, dw) of output row r reads input row r + dh - 1 from pixel dw on,
//    which moves only the start address by whole 16-byte rows: a K-major
//    store would put the dw shift inside a 16-byte row, which a descriptor
//    cannot address. Leading byte offset = 128 B (the next 8 pixels, K),
//    stride byte offset = the plane pitch (the next 8 channels, M or N).
//    Planes are padded by one pixel (1072 B and 1040 B, odd multiples of 16
//    modulo 128) so that the 8 threads storing one pixel's 8 chunks hit
//    distinct banks.
//  * The block walks its run one output row a step: warpgroup dh issues 4
//    K-steps x 3 dw = 12 products on input row r + dh - 1 and g row r.
//    While they run, the threads round input row r + 2 and g row r + 1 to
//    bf16 into the free ring slots, from a staging ring where cp.async
//    brought them as they are (float32 or bf16, 33 KB or 17 KB a row step)
//    two steps earlier, and issue the copies of input row r + 4 and g row
//    r + 3. Then cp.async.wait_group 1, fence.proxy.async (the generic-proxy
//    writes become visible to wgmma), wgmma.wait_group 0 and __syncthreads.
//    Two row steps of loads stay in flight across each barrier: loaded one
//    step ahead through registers (all that 168 registers allow beside the
//    accumulators), the loads' latency set the pace. Out-of-image pixels,
//    channels past Cin and columns past Co are zero-filled by the copies.
//    At the start of a strip the ring is filled with its two halo rows
//    first.
//  * Runs are cut from the N * ceil(W/64) * H (strip, row) pairs in
//    strip-major order (a run may cross into the next strip), so that every
//    ci tile gets about 132 / tiles blocks: one block an SM, one wave at
//    every Cin, and partials of about 19 MB at the training shapes.
// Where a row step goes (PERF.md, kernel D): the products alone run near the
// shared-memory rate (two 2 KB operand reads a product, 147 KB a step), and
// the copies plus the rounding (83 KB of shared-memory traffic a step at
// float32) overlap them only in part.
// ptxas of CUDA 12.9 segfaults on this kernel at -O1 to -O3 when its
// fence.proxy.async is inlined; kept out of line, the fence builds at -O3.
// Left for later work: cutting the shared-memory traffic (g as the register
// operand, or g stored once per dw shift for one m64n192 product a
// K-step), warp specialisation, a TMA-fed ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;                  // three warpgroups, one per dh
constexpr int kCols = 64;                      // output columns of a strip
constexpr int kCI = 64, kCO = 64;              // ci tile, output channels
constexpr int kXPix = kCols + 2;               // haloed input pixels a row
constexpr int kXPlane = (kXPix + 1) * 16;      // 1072 B, one chunk plane
constexpr int kGPlane = (kCols + 1) * 16;      // 1040 B
constexpr int kXRowBytes = 8 * kXPlane;        // 8,576
constexpr int kGRowBytes = 8 * kGPlane;        // 8,320
constexpr int kXSlots = 4, kGSlots = 2;
constexpr int kGBase = kXSlots * kXRowBytes;   // 34,304
constexpr int kRingBytes = kGBase + kGSlots * kGRowBytes;  // 50,944
constexpr int kXUnits = kXPix * 8;             // 16-byte chunks of an x row
constexpr int kUnits = kXUnits + kCols * 8;    // ... and of a g row
constexpr int kRoundPerThread = (kUnits + kThreads - 1) / kThreads;  // 3
constexpr int kLag = 2;                        // row sets in flight
constexpr int kStages = kLag + 1;              // ... and the one rounded
static_assert(kThreads % 8 == 0 && kXUnits % 8 == 0, "unit chunk");
static_assert(kXPlane % 16 == 0 && kGPlane % 16 == 0, "plane alignment");

struct Plan {
  int h, wd, cin, co;
  int strips_w;        // ceil(W / 64)
  int rows;            // N * strips_w * H (strip, row) pairs
  int rows_per_chunk;  // a block's run
};

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

// Shared-memory matrix descriptor without swizzle (layout type 0): start
// address, leading byte offset and stride byte offset, in 16-byte units.
// MN-major: leading = between core matrices adjacent in K, stride = between
// 8-channel groups in M or N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// d (64 x 64, float32) += a (64 x 16) * b (16 x 64), both bf16 in shared
// memory, MN-major (transpose flags 1, 1).
__device__ __forceinline__ void wgmma_m64n64k16_mn(float (&d)[32], uint64_t a,
                                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n"
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

// Makes this thread's generic-proxy writes to shared memory visible to
// wgmma's async proxy. Kept out of line: inlined into this kernel, it makes
// ptxas of CUDA 12.9 segfault at every level above -O0.
__device__ __noinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The rows as they arrive, before rounding: a stage holds one input row
// [66 pixels][64 channels] and one g row [64 pixels][64 channels] of T.
template <typename T>
struct Raw {
  static constexpr int kPixBytes = kCI * sizeof(T);
  static constexpr int kXBytes = kXPix * kPixBytes;
  static constexpr int kStageBytes = kXBytes + kCols * kPixBytes;
  static constexpr int kXUnits = kXBytes / 16;       // 16-byte copies
  static constexpr int kUnits = kStageBytes / 16;
  static constexpr int kPerThread = (kUnits + kThreads - 1) / kThreads;
  static constexpr int kPixUnits = kPixBytes / 16;   // copies a pixel
  static constexpr int kSmemBytes = kRingBytes + kStages * kStageBytes;
};

// grid (ceil(Cin / 64), chunks); block (ci tile, chunk) writes
// part[chunk][9][Cin][Co] for its 64 input channels.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgrad_sm90_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          float* __restrict__ part, Plan p) {
  using R = Raw<T>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* const raw = smem + kRingBytes;
  const int tid = threadIdx.x, wg = tid / 128;
  const int ci0 = blockIdx.x * kCI, chunk = blockIdx.y;

  // A segment's row sets, s = 0, 1, ...: input row r0 - 1 + s and, from
  // s = 2 on, g row r0 + s - 2. Set s is copied into stage s % kStages.
  // Copy unit v = tid + k * kThreads of a set: 16 bytes of haloed input
  // pixel v / kPixUnits (v < kXUnits) or of a g pixel. cgoff: its element
  // offset within an image row, -1 where it reads zero; kind 0 x, 1 g, 2
  // none.
  int ckind[R::kPerThread], cgoff[R::kPerThread];
  const T* ximg = x;
  const T* gimg = g;
  int r0 = 0;

  auto setup = [&](int w0) {
#pragma unroll
    for (int k = 0; k < R::kPerThread; ++k) {
      const int v = tid + k * kThreads;
      const int part16 = v % R::kPixUnits, ch = part16 * (16 / sizeof(T));
      if (v < R::kXUnits) {
        const int col = w0 - 1 + v / R::kPixUnits;
        ckind[k] = 0;
        cgoff[k] = col >= 0 && col < p.wd && ci0 + ch < p.cin
                       ? col * p.cin + ci0 + ch : -1;
      } else if (v < R::kUnits) {
        const int col = w0 + (v - R::kXUnits) / R::kPixUnits;
        ckind[k] = 1;
        cgoff[k] = col < p.wd && ch < p.co ? col * p.co + ch : -1;
      } else {
        ckind[k] = 2;
      }
    }
  };
  auto issue = [&](int s) {
    const int xr = r0 - 1 + s, gr = r0 + s - 2;
    uint8_t* stage = raw + (s % kStages) * R::kStageBytes;
#pragma unroll
    for (int k = 0; k < R::kPerThread; ++k) {
      if (ckind[k] == 2 || (ckind[k] == 1 && s < 2)) continue;
      const T* src = nullptr;
      if (cgoff[k] >= 0 && ckind[k] == 1)
        src = gimg + (size_t)gr * p.wd * p.co + cgoff[k];
      else if (cgoff[k] >= 0 && xr >= 0 && xr < p.h)
        src = ximg + (size_t)xr * p.wd * p.cin + cgoff[k];
      cp_async16(stage + (tid + k * kThreads) * 16,
                 src ? (const void*)src : (const void*)x, src ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // Round set s into the ring: unit u = tid + k * kThreads is channel chunk
  // u % 8 of input pixel u / 8 (u < kXUnits) or of g pixel
  // (u - kXUnits) / 8; input row i goes to ring slot (i + 1) % 4, g row i
  // to slot i % 2.
  auto convert = [&](int s) {
    const int xr = r0 - 1 + s, gr = r0 + s - 2;
    const uint8_t* stage = raw + (s % kStages) * R::kStageBytes;
    const int c8 = tid & 7;
#pragma unroll
    for (int k = 0; k < kRoundPerThread; ++k) {
      const int u = tid + k * kThreads;
      if (u >= kUnits || (u >= kXUnits && s < 2)) continue;
      const bool is_x = u < kXUnits;
      const int pix = is_x ? u >> 3 : (u - kXUnits) >> 3;
      const uint8_t* src = stage + (is_x ? 0 : R::kXBytes) +
                           pix * R::kPixBytes + c8 * 8 * sizeof(T);
      uint8_t* dst = smem + (is_x ? ((xr + 1) & 3) * kXRowBytes +
                                        c8 * kXPlane
                                  : kGBase + (gr & 1) * kGRowBytes +
                                        c8 * kGPlane) + pix * 16;
      uint4 v;
      if constexpr (sizeof(T) == 4) {
        // Threads of chunk 4-7 read their second half first: the eight
        // threads of one pixel then hit eight distinct bank groups.
        const int h = (c8 >> 2) & 1;
        const float4 p0 = *reinterpret_cast<const float4*>(src + 16 * h);
        const float4 p1 = *reinterpret_cast<const float4*>(src + 16 - 16 * h);
        v = h ? pack8_bf16(p1, p0) : pack8_bf16(p0, p1);
      } else {
        v = *reinterpret_cast<const uint4*>(src);
      }
      *reinterpret_cast<uint4*>(dst) = v;
    }
  };

  float acc[3][32];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[i][j] = 0.f;

  // Descriptors of slot 0; offsets below in 16-byte units (one pixel).
  const uint32_t base = smem_addr(smem);
  const uint64_t a_desc = make_desc(base, 128, kXPlane);
  const uint64_t b_desc = make_desc(base + kGBase, 128, kGPlane);

  const int begin = chunk * p.rows_per_chunk;
  const int end = min(p.rows, begin + p.rows_per_chunk);
  for (int pos = begin; pos < end;) {
    // One segment: output rows r0 .. r0 + n - 1 of one strip, row sets
    // 0 .. n + 1.
    const int strip = pos / p.h;
    r0 = pos - strip * p.h;
    const int n = min(p.h - r0, end - pos), sets = n + 2;
    const int img = strip / p.strips_w;
    setup((strip - img * p.strips_w) * kCols);
    ximg = x + (size_t)img * p.h * p.wd * p.cin;
    gimg = g + (size_t)img * p.h * p.wd * p.co;
    // Prologue: sets 0-2 (input rows r0 - 1 .. r0 + 1, g row r0) into the
    // ring; sets 3 .. 2 + kLag issued, set 3 landed.
#pragma unroll
    for (int s = 0; s < 3; ++s) issue(s);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 3; ++s) convert(s);
    proxy_fence();
    __syncthreads();
#pragma unroll
    for (int s = 3; s < 3 + kLag; ++s) {
      if (s < sets)
        issue(s);
      else
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kLag - 1) : "memory");
    __syncthreads();

    for (int i = 0; i < n; ++i) {
      // Step i: output row r = r0 + i from input rows r - 1 .. r + 1 and g
      // row r; set i + 3 (input row r + 2, g row r + 1) is rounded into
      // the ring and set i + 3 + kLag issued.
      const int r = r0 + i;
      const uint64_t a = a_desc + ((r + wg) & 3) * (kXRowBytes / 16);
      const uint64_t b = b_desc + (r & 1) * (kGRowBytes / 16);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < kCols / 16; ++ks)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw)
          wgmma_m64n64k16_mn(acc[dw], a + ks * 16 + dw, b + ks * 16);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (i + 3 < sets) convert(i + 3);
      if (i + 3 + kLag < sets) issue(i + 3 + kLag);
      else asm volatile("cp.async.commit_group;\n" ::: "memory");
      // This thread's copies of set i + 4 have landed; the barrier below
      // makes everyone's visible.
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kLag - 1) : "memory");
      proxy_fence();
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < 3; ++j) fence_operands(acc[j]);
      __syncthreads();
    }
    pos += n;
  }

  // Accumulator (m64nN): warp q of the warpgroup holds rows (ci)
  // 16q + lane / 4 and + 8, columns (co) 8j + 2 (lane % 4) and + 1 of each
  // n8 block j.
  const int q = (tid / 32) & 3, lane = tid & 31;
  const int cc = 2 * (lane & 3);
  float* out = part + (size_t)chunk * 9 * p.cin * p.co;
#pragma unroll
  for (int dw = 0; dw < 3; ++dw) {
    float* tap = out + (size_t)(3 * wg + dw) * p.cin * p.co;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = ci0 + 16 * q + (lane >> 2) + 8 * half;
      if (ci >= p.cin) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (8 * j + cc < p.co)
          *reinterpret_cast<float2*>(tap + (size_t)ci * p.co + 8 * j + cc) =
              make_float2(acc[dw][4 * j + 2 * half],
                          acc[dw][4 * j + 2 * half + 1]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* g, void* part, const Plan& p,
           int chunks, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_wgrad_sm90_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Raw<T>::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((p.cin + kCI - 1) / kCI, chunks);
  conv3x3_wgrad_sm90_kernel<T>
      <<<grid, kThreads, Raw<T>::kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<float*>(part), p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, Cin) and g (N, H, W, Co) of in_dtype (0 float32, 1 bfloat16),
// 16-byte aligned; Cin a multiple of 8, Co a multiple of 8 up to 64. part:
// caller-allocated float32 [chunks][9][Cin][Co]; chunk c sums the (strip,
// row) pairs c * rows_per_chunk .. (c + 1) * rows_per_chunk - 1 of the
// N * ceil(W / 64) * H, strip-major, and every chunk must hold at least one.
// conv3x3_wgrad_reduce (conv3x3_wgrad.cu) sums the chunks into dk. Launches
// on `stream` and returns cudaGetLastError().
extern "C" int conv3x3_wgrad_sm90(const void* x, const void* g, void* part,
                                  int n, int h, int wd, int cin, int co,
                                  int rows_per_chunk, int chunks,
                                  int in_dtype, void* stream) {
  if (cin <= 0 || cin % 8 || co <= 0 || co % 8 || co > kCO || n <= 0 ||
      h <= 0 || wd <= 0 || rows_per_chunk <= 0 || chunks <= 0 ||
      chunks > 65535 || (long long)wd * cin >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Plan p;
  p.h = h;
  p.wd = wd;
  p.cin = cin;
  p.co = co;
  p.strips_w = (wd + kCols - 1) / kCols;
  const long long rows = (long long)n * p.strips_w * h;
  if (rows >= (1LL << 31) ||
      (long long)(chunks - 1) * rows_per_chunk >= rows ||
      (long long)chunks * rows_per_chunk < rows)
    return (int)cudaErrorInvalidValue;
  p.rows = (int)rows;
  p.rows_per_chunk = rows_per_chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1) return launch<__nv_bfloat16>(x, g, part, p, chunks, s);
  return launch<float>(x, g, part, p, chunks, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
