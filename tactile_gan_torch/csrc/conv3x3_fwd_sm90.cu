// Every bf16-operand 3x3 / stride 1 / zero-padding 1 convolution of the port
// at Cin % 8 == 0, on Hopper's warpgroup matrix multiply (wgmma, sm_90a),
// NHWC in and out. One body, three uses, each with a __global__ name of its
// own so that a profile tells them apart:
//  * conv3x3_fwd_sm90_kernel: kernel B's forward at Co 16, 32 or 64 (the
//    full-resolution row of UNet++), output in x's dtype. Replaces the
//    forward of the Pallas kernel tactile_gan_tpu/ops/pallas/conv3x3.py
//    conv3x3_packed (_kernel_packed); its packed (N, H*W/2, 2C) operand is
//    NHWC memory, so here it is a plain channels-last conv.
//  * conv3x3_dgrad_sm90_kernel: B-dx, the input gradient of that conv: the
//    same conv of g with the rotated-transposed weight (ops/packed_row.py
//    _rot_t), K = the forward's Co (<= 64), Co = the forward's Cin (up to
//    384), output in g's dtype.
//  * conv3x3_p1_sm90_kernel: kernel E, the Pallas probe functions
//    conv3x3_p1 (W-pairs) and conv3x3_p1_h (H-pairs) of that file: any
//    Co >= 1, a float32 output. The pairing filled the TPU's 128 MXU lanes
//    and has no counterpart here.
// The other convs (float32 compute; widths off Cin % 8 == 0 or, for B and
// B-dx, off Co 16/32/64) run conv3x3.cu.
//
// y (N, H, W, Co) = conv(x (N, H, W, Cin)), Cin a multiple of 8, x float32 or
// bfloat16, operands rounded to bf16, float32 sums; any H, W >= 1.
//
// Bound: bytes where x is float32 (the training step and E's probe: (Cin +
// Co) * 4 bytes a pixel against 2 * 9 * Cin * Co flops, under the card's ~295
// flop/byte bf16 ridge at every width of the row), operations at the larger
// widths with a bf16 input: the least time is the larger of bytes / 3.35
// TB/s and flops / 989 TFLOP/s.
//
// Design (an implicit GEMM: M = 64 consecutive output pixels of one row,
// N = a tile of 16, 32 or 64 output channels (template N), K = 16 channels
// of one tap):
//  * A block of two warpgroups (256 threads) owns a 4 x 64 output tile;
//    warpgroup g owns output rows 2g and 2g + 1, two m64nN float32
//    accumulators (2 x N/2 registers a thread).
//  * Cin is walked in 16-channel slices. An input slot holds the 6 x 66
//    haloed input tile of one slice as two chunk planes [chunk 0|1][halo
//    pixel][8 bf16]; a weight slot holds one slice of one Co tile as
//    [9 taps][chunk 0|1][N co][8 bf16]. In wgmma's K-major layout without
//    swizzle a core matrix is 8 rows of 16 bytes, contiguous: any 8
//    consecutive pixels of a halo row are one, so the A operand of tap
//    (dh, dw) for output row r starts at halo pixel (r + dh) * 66 + dw and
//    the tile is written once and read by all 9 taps. Leading byte offset =
//    the distance between the two chunk planes (the input slot's plane, or
//    N * 16 for the weights), stride byte offset = 128 bytes (the next 8
//    rows). Each warpgroup issues 9 taps x 2 rows = 18 products a step.
//  * The block walks every Co tile of its pixels: steps (tile, slice) in
//    order. Where the input has at most 4 slices (Cin <= 64: B-dx at every
//    width, E at the probe's) it stays resident: slot s holds slice s,
//    loaded during the first tile only, and the later tiles stream only
//    their weights (50,688 bytes of input at Cin 64, two blocks an SM).
//    Wider inputs go through two input slots in turn, reloaded every step.
//    Co is never walked on the grid, so a float32 g is read and rounded once
//    per block, not once per Co tile. B's forward has one tile by
//    construction (template kTiles false: its loop is the single-tile one,
//    with no resident slots; the runtime tile walk cost its bf16-input path
//    2-4%).
//  * Weights go through two slots in turn. While the products of step t run
//    (wgmma is asynchronous), the threads load step t + 1: a float32 input
//    through registers, rounded to bf16 on its way (TMA could not round), a
//    bf16 input and the weights by cp.async. Then cp.async.wait_all,
//    fence.proxy.async (the generic-proxy writes become visible to wgmma's
//    async proxy), wgmma.wait_group 0 and __syncthreads. Out-of-image halo
//    pixels and channels past Cin are zero-filled. After a tile's last slice
//    (outside the slice loop, its addresses computed there from an opaque
//    thread index, so that none is held in a register across the products)
//    its accumulators are stored and cleared: at N = 64 with a float32
//    input the body fits 2 blocks an SM (122-126 registers) without
//    spilling. With the store inside the step loop it spilled and ran a
//    third slower.
//  * The weights arrive pre-laid by the wrapper as [tiles * slices][9][2][N]
//    [8] bf16 (Cin zero-padded to a multiple of 16, Co to whole tiles), so
//    a step's weights are one contiguous copy; channels past Co are not
//    stored (pairs where Co is even, else one at a time).
// The proxy fence is a __noinline__ function: inlined, ptxas of CUDA 12.9
// segfaults on it (at -O3, and at -O1 in this loop's form; at every level
// but -O0 in conv3x3_wgrad_sm90.cu). Out of line it builds with the common
// flags (ops/kernels/build.py), and -O3 ran faster than -O1.
// Left for later work: a deeper ring, warp specialisation, a persistent
// grid, the float32 input staged by cp.async and rounded in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                  // two warpgroups
constexpr int kRows = 4, kCols = 64;           // output tile
constexpr int kHaloW = kCols + 2;
constexpr int kHaloPix = (kRows + 2) * kHaloW;  // 396
constexpr int kKC = 16;                        // Cin slice
constexpr int kPlaneBytes = kHaloPix * 16;     // one chunk plane
constexpr int kXBytes = 2 * kPlaneBytes;       // 12,672: one input slot
constexpr int kXUnits = kHaloPix * 2;          // 16-byte units of a slot
constexpr int kXPerThread = (kXUnits + kThreads - 1) / kThreads;
constexpr int kMaxResident = 4;                // resident slices (Cin <= 64)
static_assert(kXBytes % 128 == 0, "slot alignment");

// The sizes of one Co tile of N channels.
template <int N>
struct CoTile {
  static constexpr int kTapBytes = 2 * N * 16;  // one tap's two planes
  static constexpr int kWBytes = 9 * kTapBytes;  // one weight slot
  static constexpr int kWUnits = kWBytes / 16;
  static constexpr int kAcc = N / 2;            // accumulators a row
  // The largest layout: resident input and two weight slots.
  static constexpr int kMaxSmem = kMaxResident * kXBytes + 2 * kWBytes;
  static_assert(kWBytes % 128 == 0, "slot alignment");
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

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy that wgmma reads through. Out of line: see the header.
__device__ __noinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
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

// d (64 x N, float32) += a (64 x 16) * b (N x 16)^T, both bf16 in shared
// memory through their descriptors; one overload per N.
__device__ __forceinline__ void wgmma(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t a,
                                      uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a,
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
template <int A>
__device__ __forceinline__ void fence_operands(float (&d)[A]) {
#pragma unroll
  for (int i = 0; i < A; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The widths of one launch.
struct Dims {
  int h, wd, cin, slices, co_total, tiles;
  int resident;  // 1: the input stays in shared memory across the Co tiles
};

// kTiles: the launch may walk several Co tiles (B-dx, E); false for B's
// forward, which has one.
template <typename T, typename OUT, int N, bool kTiles>
__device__ __forceinline__ void conv_body(const T* __restrict__ x,
                                          const __nv_bfloat16* __restrict__ w,
                                          OUT* __restrict__ y, const Dims d) {
  using Tile = CoTile<N>;
  constexpr bool kF32In = sizeof(T) == 4;
  extern __shared__ __align__(128) uint8_t smem[];
  const int h = d.h, wd = d.wd, cin = d.cin, slices = d.slices;
  const int tiles = kTiles ? d.tiles : 1;
  const bool resident = kTiles && d.resident;
  const int w0 = blockIdx.x * kCols, h0 = blockIdx.y * kRows;
  const int img = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const T* ximg = x + (size_t)img * h * wd * cin;
  // Input slots, then the two weight slots.
  const int x_slots = resident ? slices : 2;
  uint8_t* wsm = smem + x_slots * kXBytes;

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
  // Step t = tile * slices + s: its weights are the t-th slot-sized run.
  auto load_weights = [&](int t, uint8_t* ws) {
    const uint4* src =
        reinterpret_cast<const uint4*>(w) + (size_t)t * Tile::kWUnits;
    for (int u = threadIdx.x; u < Tile::kWUnits; u += kThreads)
      cp_async16(ws + u * 16, src + u, 16);
  };
  auto publish = [&]() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    proxy_fence();
  };

  float acc[2][Tile::kAcc];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < Tile::kAcc; ++j) acc[i][j] = 0.f;

  // Accumulator (m64nN): warp q of the warpgroup holds rows 16q + lane / 4
  // and + 8, columns 8j + 2 (lane % 4) and + 1 of each n8 block j. The
  // addresses start from an opaque copy of the thread index, so the
  // compiler cannot hoist them into registers held across the products.
  auto store_tile = [&](int tile) {
    int tid = threadIdx.x;
    asm volatile("" : "+r"(tid));
    const int q = (tid / 32) & 3, lane = tid & 31, cc = 2 * (lane & 3);
    const int co_total = d.co_total;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int oh = blockIdx.y * kRows + 2 * (tid / 128) + r;
      if (oh >= h) continue;
      OUT* yrow = y + ((size_t)blockIdx.z * h + oh) * wd * co_total;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ow = blockIdx.x * kCols + 16 * q + (lane >> 2) + 8 * half;
        if (ow >= wd) continue;
        OUT* p = yrow + (size_t)ow * co_total;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int c = tile * N + 8 * j + cc;
          const float a = acc[r][4 * j + 2 * half];
          const float b = acc[r][4 * j + 2 * half + 1];
          if (co_total % 2 == 0) {  // pairs are aligned
            if (c < co_total) store2(p + c, a, b);
          } else {
            if (c < co_total) store1(p + c, a);
            if (c + 1 < co_total) store1(p + c + 1, b);
          }
        }
      }
    }
  };

  // Descriptors of slot 0: A at halo row 2 * wg (the warpgroup's first
  // output row, tap (0, 0)), B at tap 0. Offsets below are in 16-byte units:
  // one halo pixel, or one 16-byte weight row.
  const uint32_t base = smem_addr(smem);
  const uint64_t a_desc = make_desc(base + 2 * wg * kHaloW * 16, kPlaneBytes,
                                    128);
  const uint64_t b_desc = make_desc(smem_addr(wsm), N * 16, 128);

  // Prologue: step 0 into slot 0.
  load_input(0, smem);
  load_weights(0, wsm);
  store_input(smem);
  publish();
  __syncthreads();

  // Step t = tile * slices + s; a resident input sits in slot s, a
  // streamed one in slot t % 2.
  const int steps = tiles * slices;
  int t = 0;
  for (int tile = 0; tile < tiles; ++tile) {
    for (int s = 0; s < slices; ++s, ++t) {
      const uint64_t xo = (uint64_t)((resident ? s : t & 1) * (kXBytes / 16));
      const uint64_t wo = (uint64_t)((t & 1) * (Tile::kWBytes / 16));
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dh = tap / 3, dw = tap % 3;
        const uint64_t b = b_desc + wo + tap * (Tile::kTapBytes / 16);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          wgmma(acc[r], a_desc + xo + (r + dh) * kHaloW + dw, b);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (t + 1 < steps) {
        const int sn = s + 1 < slices ? s + 1 : 0;
        // A resident input is loaded during the first tile only.
        const bool input = !resident || (tile == 0 && s + 1 < slices);
        uint8_t* xn = smem + (resident ? sn : (t + 1) & 1) * kXBytes;
        if (input) load_input(sn, xn);
        load_weights(t + 1, wsm + ((t + 1) & 1) * Tile::kWBytes);
        if (input) store_input(xn);
      }
      publish();
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc[0]);
      fence_operands(acc[1]);
      __syncthreads();
    }
    store_tile(tile);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < Tile::kAcc; ++j) acc[i][j] = 0.f;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_fwd_sm90_kernel(const T* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        T* __restrict__ y, const Dims d) {
  conv_body<T, T, N, false>(x, w, y, d);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_dgrad_sm90_kernel(const T* __restrict__ g,
                          const __nv_bfloat16* __restrict__ w,
                          T* __restrict__ dx, const Dims d) {
  conv_body<T, T, N, true>(g, w, dx, d);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_p1_sm90_kernel(const T* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       float* __restrict__ y, const Dims d) {
  conv_body<T, float, N, true>(x, w, y, d);
}

// The three uses of the body: B's forward, B-dx, kernel E.
enum Use { kForward = 0, kDgrad = 1, kP1 = 2 };

template <typename T, typename OUT, int N>
int launch_one(void (*kernel)(const T*, const __nv_bfloat16*, OUT*, Dims),
               bool& configured, const void* x, const void* w, void* y,
               int n, const Dims& d, cudaStream_t stream) {
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        CoTile<N>::kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int smem =
      (d.resident ? d.slices : 2) * kXBytes + 2 * CoTile<N>::kWBytes;
  const dim3 grid((d.wd + kCols - 1) / kCols, (d.h + kRows - 1) / kRows, n);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                           static_cast<const __nv_bfloat16*>(w),
                                           static_cast<OUT*>(y), d);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int launch(int use, const void* x, const void* w, void* y, int n,
           const Dims& d, cudaStream_t stream) {
  static bool configured[3] = {false, false, false};
  switch (use) {
    case kForward:
      return launch_one<T, T, N>(conv3x3_fwd_sm90_kernel<T, N>,
                                 configured[kForward], x, w, y, n, d, stream);
    case kDgrad:
      return launch_one<T, T, N>(conv3x3_dgrad_sm90_kernel<T, N>,
                                 configured[kDgrad], x, w, y, n, d, stream);
    default:
      return launch_one<T, float, N>(conv3x3_p1_sm90_kernel<T, N>,
                                     configured[kP1], x, w, y, n, d, stream);
  }
}

template <typename T>
int dispatch_n(int use, int co_tile, const void* x, const void* w, void* y,
               int n, const Dims& d, cudaStream_t stream) {
  switch (co_tile) {
    case 16: return launch<T, 16>(use, x, w, y, n, d, stream);
    case 32: return launch<T, 32>(use, x, w, y, n, d, stream);
    default: return launch<T, 64>(use, x, w, y, n, d, stream);
  }
}

int run(int use, const void* x, const void* w, void* y, int n, int h, int wd,
        int cin, int co_total, int co_tile, int in_dtype, void* stream) {
  if ((co_tile != 16 && co_tile != 32 && co_tile != 64) || cin <= 0 ||
      cin % 8 || co_total <= 0 || n <= 0 || h <= 0 || wd <= 0 ||
      (use != kP1 && co_total % 8) || (use == kForward && co_total > co_tile) ||
      n > 65535 || (h + kRows - 1) / kRows > 65535 ||
      (long long)h * wd * cin >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Dims d;
  d.h = h;
  d.wd = wd;
  d.cin = cin;
  d.slices = (cin + kKC - 1) / kKC;
  d.co_total = co_total;
  d.tiles = (co_total + co_tile - 1) / co_tile;
  d.resident = d.tiles > 1 && d.slices <= kMaxResident;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1)
    return dispatch_n<__nv_bfloat16>(use, co_tile, x, w, y, n, d, s);
  return dispatch_n<float>(use, co_tile, x, w, y, n, d, s);
}

}  // namespace

// Every entry: x (N, H, W, Cin) in_dtype (0 float32, 1 bfloat16), Cin a
// multiple of 8, 16-byte aligned; w: [tiles * slices][9][2][co_tile][8]
// bfloat16, slices = Cin / 16 rounded up, tiles = co_total / co_tile rounded
// up, zero past Cin and past co_total; co_tile 16, 32 or 64. Each returns
// cudaGetLastError().

// Kernel B's forward: y (N, H, W, co) in x's dtype, co 16, 32 or 64 (one
// tile, co_tile == co).
extern "C" int conv3x3_fwd_sm90(const void* x, const void* w, void* y, int n,
                                int h, int wd, int cin, int co, int co_tile,
                                int in_dtype, void* stream) {
  return run(kForward, x, w, y, n, h, wd, cin, co, co_tile, in_dtype, stream);
}

// B-dx: g (N, H, W, Cin = the forward's Co) -> dx (N, H, W, co_total = the
// forward's Cin, a multiple of 8) in g's dtype; w is the rotated-transposed
// weight laid out as above.
extern "C" int conv3x3_dgrad_sm90(const void* g, const void* w, void* dx,
                                  int n, int h, int wd, int cin, int co_total,
                                  int co_tile, int in_dtype, void* stream) {
  return run(kDgrad, g, w, dx, n, h, wd, cin, co_total, co_tile, in_dtype,
             stream);
}

// Kernel E: y (N, H, W, co_total) float32, any co_total >= 1.
extern "C" int conv3x3_p1_sm90(const void* x, const void* w, void* y, int n,
                               int h, int wd, int cin, int co_total,
                               int co_tile, int in_dtype, void* stream) {
  return run(kP1, x, w, y, n, h, wd, cin, co_total, co_tile, in_dtype,
             stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
