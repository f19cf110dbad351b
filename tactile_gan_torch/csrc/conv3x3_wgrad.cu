// Weight gradient of the 3x3 / stride 1 / zero-padding 1 convolution, NHWC,
// for the full-resolution row of UNet++ on Hopper (sm_90a). Replaces the
// Pallas kernel tactile_gan_tpu/ops/pallas/conv3x3.py conv3x3_packed_wgrad
// (_kernel_packed_wgrad) and its fold ops/packed_row.py _dk_from_db: this
// kernel writes the OIHW float32 weight gradient directly,
//   dk[co][ci][ky][kx] = sum_p x[p + (ky - 1, kx - 1)][ci] * g[p][co],
// with x read as zero outside the image.
//
// It is a GEMM with M = 9 * Cin (576-3456 at nf=64), N = Co = 64 and
// K = N*H*W pixels (262,144 at batch 4 and 256x256). Bound: at f32 inputs
// the bytes (read x and g once: (Cin + Co) * 4 B a pixel against
// 2 * 9 * Cin * Co flops a pixel) and the operations come within a factor of
// two of each other; see chip_smoke.py for the bound of each shape.
//
// Design:
//  * K dwarfs M x N, so the pixels are split across blocks: block
//    (ci tile, chunk) owns 32 input channels x all 64 output channels of dk
//    and a run of 8 x 32-pixel tiles of the images. Blocks run in no order
//    and a float atomic sum would change from run to run, so each block
//    writes its partial dk to scratch and a second launch sums the chunks in
//    a fixed order: the result is the same on every run.
//  * bf16 compute (tensor cores, mma.sync m16n8k16, float32 accumulators):
//    per tile, the haloed 10 x 34 input tile (32 channels) and the 8 x 32 g
//    tile (64 channels) are rounded to bf16 on their way into shared memory
//    (zero outside the image). Warp w owns 16 input channels (w / 4) x 16
//    output channels (w % 4) for all 9 taps: 72 float32 accumulators a
//    thread. Both operands are read with ldmatrix.trans from pixel-major
//    rows whose 16-byte chunks are XOR-swizzled so the eight rows of each
//    ldmatrix phase fall in distinct banks. Each tap's A operand is the same
//    shared tile read at a shifted pixel offset.
//  * float32 compute (CUDA cores): the same tiles in float32; thread t owns
//    output channel t % 64 and 8 input channels (t / 64) for all 9 taps.
//  * Cin any multiple of 8 (channels past Cin read as zero and are not
//    stored), Co any multiple of 8 up to 64.
// Left for later work: pipelining the tile loads (cp.async/TMA), wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps
constexpr int kMH = 8, kMW = 32;              // output-pixel tile
constexpr int kTilePix = kMH * kMW;
constexpr int kHH = kMH + 2, kHW = kMW + 2;   // haloed input tile
constexpr int kHaloPix = kHH * kHW;
constexpr int kCI = 32;                       // input channels per block
constexpr int kCO = 64;                       // output channels (padded)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// Element offsets of 16-byte chunk c of a pixel row: x rows are 32 channels
// (4 chunks, two rows per 128 bytes), g rows 64 channels (8 chunks).
__device__ __forceinline__ int swz_x(int row, int c) {
  return row * kCI + 8 * (c ^ ((row >> 1) & 3));
}
__device__ __forceinline__ int swz_g(int row, int c) {
  return row * kCO + 8 * (c ^ (row & 7));
}

// Eight channels at p as bf16 (16 bytes), or zeros.
__device__ __forceinline__ uint4 load8_bf16(const float* p, bool ok) {
  if (!ok) return make_uint4(0u, 0u, 0u, 0u);
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(a.x, a.y);
  h[1] = __floats2bfloat162_rn(a.z, a.w);
  h[2] = __floats2bfloat162_rn(b.x, b.y);
  h[3] = __floats2bfloat162_rn(b.z, b.w);
  return raw;
}
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

// Eight channels at p as float32, or zeros.
__device__ __forceinline__ void load8_f32(const float* p, bool ok, float4& a,
                                          float4& b) {
  if (!ok) {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  a = reinterpret_cast<const float4*>(p)[0];
  b = reinterpret_cast<const float4*>(p)[1];
}
__device__ __forceinline__ void load8_f32(const __nv_bfloat16* p, bool ok,
                                          float4& a, float4& b) {
  if (!ok) {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
  const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
  a = make_float4(f0.x, f0.y, f1.x, f1.y);
  b = make_float4(f2.x, f2.y, f3.x, f3.y);
}

struct Geometry {
  int h, wd, cin, co, tiles_h, tiles_w, tiles, tiles_per_chunk;
};

// The spatial tile t of the run: (image, first output row, first column).
__device__ __forceinline__ void tile_origin(const Geometry& gm, int t,
                                            int& img, int& h0, int& w0) {
  const int per_img = gm.tiles_h * gm.tiles_w;
  img = t / per_img;
  const int r = t % per_img;
  h0 = (r / gm.tiles_w) * kMH;
  w0 = (r % gm.tiles_w) * kMW;
}

// grid (ceil(Cin / 32), chunks). Dynamic shared memory: the bf16 x halo
// tile and g tile. part: [chunk][9][Cin][Co] float32.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wgrad_bf16_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  float* __restrict__ part, Geometry gm) {
  extern __shared__ __align__(128) __nv_bfloat16 smem[];
  __nv_bfloat16* xs = smem;                      // [kHaloPix][32]
  __nv_bfloat16* gs = smem + kHaloPix * kCI;     // [kTilePix][64]

  const int ci_base = blockIdx.x * kCI, chunk = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ci_half = warp >> 2, co_q = warp & 3;

  float acc[9][2][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  // ldmatrix lane roles (.trans, rows are pixels). A (16 ci x 16 pixels):
  // matrix q = lane / 8 covers pixels 8 * (q / 2) + lane % 8, channel chunk
  // q % 2 of this warp's half. B (16 pixels x 16 co): pixels
  // 8 * ((lane / 8) % 2) + lane % 8, channel chunk lane / 16 of this warp's
  // quarter.
  const int a_pix = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int a_chunk = 2 * ci_half + ((lane >> 3) & 1);
  const int b_pix = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_chunk = 2 * co_q + (lane >> 4);

  const int t_begin = chunk * gm.tiles_per_chunk;
  const int t_end = min(gm.tiles, t_begin + gm.tiles_per_chunk);
  for (int t = t_begin; t < t_end; ++t) {
    int img, h0, w0;
    tile_origin(gm, t, img, h0, w0);
    const size_t img_pix = (size_t)img * gm.h * gm.wd;
    for (int u = threadIdx.x; u < kHaloPix * 4; u += kThreads) {
      const int pix = u >> 2, c = u & 3;
      const int ih = h0 - 1 + pix / kHW, iw = w0 - 1 + pix % kHW;
      const int ci = ci_base + c * 8;
      const bool ok = ih >= 0 && ih < gm.h && iw >= 0 && iw < gm.wd &&
                      ci < gm.cin;
      const T* src = x + (img_pix + (size_t)ih * gm.wd + iw) * gm.cin + ci;
      *reinterpret_cast<uint4*>(xs + swz_x(pix, c)) = load8_bf16(src, ok);
    }
    for (int u = threadIdx.x; u < kTilePix * 8; u += kThreads) {
      const int pix = u >> 3, c = u & 7;
      const int oh = h0 + pix / kMW, ow = w0 + pix % kMW;
      const bool ok = oh < gm.h && ow < gm.wd && c * 8 < gm.co;
      const T* src = g + (img_pix + (size_t)oh * gm.wd + ow) * gm.co + c * 8;
      *reinterpret_cast<uint4*>(gs + swz_g(pix, c)) = load8_bf16(src, ok);
    }
    __syncthreads();

#pragma unroll 1
    for (int step = 0; step < kTilePix / 16; ++step) {
      const int r = step >> 1, col = (step & 1) * 16;
      uint32_t b[4];
      ldmatrix_x4_trans(b, gs + swz_g(r * kMW + col + b_pix, b_chunk));
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dh = tap / 3, dw = tap % 3;
        uint32_t a[4];
        ldmatrix_x4_trans(
            a, xs + swz_x((r + dh) * kHW + col + dw + a_pix, a_chunk));
        mma_bf16(acc[tap][0], a, b[0], b[1]);
        mma_bf16(acc[tap][1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  // Accumulator (m16n8): lane holds ci rows lane/4 and lane/4 + 8, co
  // columns 2 * (lane % 4) and +1 of its tile.
  const int gid = lane >> 2, cc = 2 * (lane & 3);
  float* out = part + (size_t)chunk * 9 * gm.cin * gm.co;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ci = ci_base + ci_half * 16 + gid + half * 8;
        const int co = co_q * 16 + j * 8 + cc;
        if (ci < gm.cin && co < gm.co)
          *reinterpret_cast<float2*>(
              out + ((size_t)tap * gm.cin + ci) * gm.co + co) =
              make_float2(acc[tap][j][2 * half], acc[tap][j][2 * half + 1]);
      }
}

// float32 operands and accumulation on the CUDA cores; same grid and
// partial layout as the bf16 kernel. Dynamic shared memory: the float32 x
// halo tile [kHaloPix][32] and g tile [kTilePix][64].
template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_f32_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 float* __restrict__ part, Geometry gm) {
  extern __shared__ __align__(16) float fsmem[];
  float* xs = fsmem;
  float* gs = fsmem + kHaloPix * kCI;

  const int ci_base = blockIdx.x * kCI, chunk = blockIdx.y;
  const int co = threadIdx.x & 63, cig = threadIdx.x >> 6;  // 4 groups of 8

  float acc[9][8];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[t][k] = 0.f;

  const int t_begin = chunk * gm.tiles_per_chunk;
  const int t_end = min(gm.tiles, t_begin + gm.tiles_per_chunk);
  for (int t = t_begin; t < t_end; ++t) {
    int img, h0, w0;
    tile_origin(gm, t, img, h0, w0);
    const size_t img_pix = (size_t)img * gm.h * gm.wd;
    for (int u = threadIdx.x; u < kHaloPix * 4; u += kThreads) {
      const int pix = u >> 2, c = u & 3;
      const int ih = h0 - 1 + pix / kHW, iw = w0 - 1 + pix % kHW;
      const int ci = ci_base + c * 8;
      const bool ok = ih >= 0 && ih < gm.h && iw >= 0 && iw < gm.wd &&
                      ci < gm.cin;
      float4* dst = reinterpret_cast<float4*>(xs + pix * kCI + c * 8);
      load8_f32(x + (img_pix + (size_t)ih * gm.wd + iw) * gm.cin + ci, ok,
                dst[0], dst[1]);
    }
    for (int u = threadIdx.x; u < kTilePix * 8; u += kThreads) {
      const int pix = u >> 3, c = u & 7;
      const int oh = h0 + pix / kMW, ow = w0 + pix % kMW;
      const bool ok = oh < gm.h && ow < gm.wd && c * 8 < gm.co;
      float4* dst = reinterpret_cast<float4*>(gs + pix * kCO + c * 8);
      load8_f32(g + (img_pix + (size_t)oh * gm.wd + ow) * gm.co + c * 8, ok,
                dst[0], dst[1]);
    }
    __syncthreads();
#pragma unroll 1
    for (int pix = 0; pix < kTilePix; ++pix) {
      const float gv = gs[pix * kCO + co];
      const int r = pix / kMW, col = pix % kMW;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float4* xp = reinterpret_cast<const float4*>(
            xs + ((r + tap / 3) * kHW + col + tap % 3) * kCI + cig * 8);
        const float4 a = xp[0], b = xp[1];
        acc[tap][0] = fmaf(a.x, gv, acc[tap][0]);
        acc[tap][1] = fmaf(a.y, gv, acc[tap][1]);
        acc[tap][2] = fmaf(a.z, gv, acc[tap][2]);
        acc[tap][3] = fmaf(a.w, gv, acc[tap][3]);
        acc[tap][4] = fmaf(b.x, gv, acc[tap][4]);
        acc[tap][5] = fmaf(b.y, gv, acc[tap][5]);
        acc[tap][6] = fmaf(b.z, gv, acc[tap][6]);
        acc[tap][7] = fmaf(b.w, gv, acc[tap][7]);
      }
    }
    __syncthreads();
  }

  if (co >= gm.co) return;
  float* out = part + (size_t)chunk * 9 * gm.cin * gm.co;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ci = ci_base + cig * 8 + k;
      if (ci < gm.cin) out[((size_t)tap * gm.cin + ci) * gm.co + co] = acc[tap][k];
    }
}

// Sums the chunks' partials in chunk order and writes OIHW:
// dk[co][ci][tap] = sum_chunk part[chunk][tap][ci][co].
__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dk,
                    int cin, int co, int chunks) {
  const int total = 9 * cin * co;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[(size_t)c * total + i];
  const int tap = i / (cin * co), ci = (i / co) % cin, o = i % co;
  dk[((size_t)o * cin + ci) * 9 + tap] = s;
}

template <typename T>
int launch(const void* x, const void* g, void* part, void* dk, Geometry gm,
           int chunks, int compute_bf16, cudaStream_t stream) {
  const dim3 grid((gm.cin + kCI - 1) / kCI, chunks);
  if (compute_bf16) {
    constexpr int kBytes = (kHaloPix * kCI + kTilePix * kCO) * 2;
    static bool configured = false;
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          wgrad_bf16_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kBytes);
      if (err != cudaSuccess) return (int)err;
      configured = true;
    }
    wgrad_bf16_kernel<T><<<grid, kThreads, kBytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<float*>(part), gm);
  } else {
    constexpr int kBytes = (kHaloPix * kCI + kTilePix * kCO) * 4;
    static bool configured = false;
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          wgrad_f32_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kBytes);
      if (err != cudaSuccess) return (int)err;
      configured = true;
    }
    wgrad_f32_kernel<T><<<grid, kThreads, kBytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<float*>(part), gm);
  }
  const int total = 9 * gm.cin * gm.co;
  wgrad_reduce_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(static_cast<const float*>(part),
                                  static_cast<float*>(dk), gm.cin, gm.co,
                                  chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, Cin) and g (N, H, W, Co) of in_dtype (0 float32, 1 bfloat16);
// dk (Co, Cin, 3, 3) float32. part: caller-allocated float32 scratch of
// chunks * 9 * Cin * Co; each chunk covers tiles_per_chunk of the
// N * ceil(H/8) * ceil(W/32) pixel tiles. Cin a multiple of 8, Co a multiple
// of 8 up to 64. Launches on `stream` and returns cudaGetLastError().
extern "C" int conv3x3_wgrad(const void* x, const void* g, void* part,
                             void* dk, int n, int h, int wd, int cin, int co,
                             int tiles_per_chunk, int chunks, int in_dtype,
                             int compute_bf16, void* stream) {
  if (cin <= 0 || cin % 8 || co <= 0 || co % 8 || co > kCO)
    return (int)cudaErrorInvalidValue;
  Geometry gm;
  gm.h = h;
  gm.wd = wd;
  gm.cin = cin;
  gm.co = co;
  gm.tiles_h = (h + kMH - 1) / kMH;
  gm.tiles_w = (wd + kMW - 1) / kMW;
  gm.tiles = n * gm.tiles_h * gm.tiles_w;
  gm.tiles_per_chunk = tiles_per_chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1)
    return launch<__nv_bfloat16>(x, g, part, dk, gm, chunks, compute_bf16, s);
  return launch<float>(x, g, part, dk, gm, chunks, compute_bf16, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
