// Fused instance norm + affine + activation, forward, for NHWC tensors on
// Hopper (sm_90a). Replaces the Pallas kernel
// tactile_gan_tpu/ops/pallas/instance_norm.py (instance_norm_act -> _norm_call
// -> _kernel).
//
// Bound: memory. The function reads x once and writes y once (a few flops an
// element), so the least time is 2 * numel * itemsize / 3.35 TB/s. This
// design reads x twice (statistics, then normalize) and writes y once.
//
// Design:
//  * Statistics are Welford per thread and Chan's pairwise merge across
//    threads and blocks: the two-pass biased variance to rounding, without
//    the cancellation of the TPU kernel's single-pass E[x^2] - m^2. The plain
//    twin (ops/norm.py) computes it two-pass in float32.
//  * The TPU walked a sequential grid (stats sweep, then write sweep). Blocks
//    here run in no order, so the work is three launches on one stream:
//    partial statistics, a per-(n, c) finalize, then normalize + act.
//  * Occupancy: the full-resolution row at batch 1 has only 64 (n, c) groups
//    of 65,536 pixels. The H*W axis is split across `splits` blocks per
//    (image, 64-channel tile) so the partial-statistics grid fills the 132
//    SMs; the finalize merges the splits, one warp per (n, c).
//  * Loads and stores are 8 channels (16 B of bf16, 32 B of f32) per thread;
//    C must be a multiple of 8 and the pointers 16-byte aligned (the Python
//    wrapper checks both).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileC = 64;                    // channels per stats block
constexpr int kGroups = kTileC / 8;           // 8-channel groups per tile
constexpr int kLanes = kThreads / kGroups;    // pixel lanes per stats block

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Chan's merge of (count, mean, M2) b into a.
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& m2a,
                                           float nb, float mb, float m2b) {
  const float n = na + nb;
  if (nb == 0.f) return;
  const float d = mb - ma;
  const float f = nb / n;
  ma += d * f;
  m2a += m2b + d * d * na * f;
  na = n;
}

// grid (splits, ceil(C / 64), N). Block: 8 channel groups x 32 pixel lanes.
// Writes the partial mean and M2 of each (image, split, channel).
template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, float* __restrict__ pmean,
             float* __restrict__ pm2, int hw, int c, int chunk, int splits) {
  const int split = blockIdx.x, img = blockIdx.z;
  const int g = threadIdx.x % kGroups, lane = threadIdx.x / kGroups;
  const int c0 = blockIdx.y * kTileC + g * 8;
  const bool active = c0 < c;
  const int p_begin = split * chunk;
  const int p_end = min(hw, p_begin + chunk);

  float cnt = 0.f, mean[8], m2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mean[i] = m2[i] = 0.f;
  if (active) {
    const T* base = x + (size_t)img * hw * c + c0;
    for (int p = p_begin + lane; p < p_end; p += kLanes) {
      float v[8];
      load8(base + (size_t)p * c, v);
      cnt += 1.f;
      const float inv = 1.f / cnt;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = v[i] - mean[i];
        mean[i] += d * inv;
        m2[i] += d * (v[i] - mean[i]);
      }
    }
  }

  __shared__ float s_mean[kLanes][kTileC];
  __shared__ float s_m2[kLanes][kTileC];
  __shared__ float s_cnt[kLanes][kGroups];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s_mean[lane][g * 8 + i] = mean[i];
    s_m2[lane][g * 8 + i] = m2[i];
  }
  s_cnt[lane][g] = cnt;
  __syncthreads();
  for (int s = kLanes / 2; s > 0; s >>= 1) {
    if (lane < s) {
      const float nb = s_cnt[lane + s][g];
      float na = cnt;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        na = cnt;
        chan_merge(na, mean[i], m2[i], nb, s_mean[lane + s][g * 8 + i],
                   s_m2[lane + s][g * 8 + i]);
      }
      cnt = na;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s_mean[lane][g * 8 + i] = mean[i];
        s_m2[lane][g * 8 + i] = m2[i];
      }
      s_cnt[lane][g] = cnt;
    }
    __syncthreads();
  }
  if (lane == 0 && active) {
    float* pm = pmean + ((size_t)img * splits + split) * c + c0;
    float* pq = pm2 + ((size_t)img * splits + split) * c + c0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      pm[i] = mean[i];
      pq[i] = m2[i];
    }
  }
}

// One warp per (image, channel): the lanes merge strided splits, then a
// shuffle tree merges the lanes. (A thread per (image, channel) walking all
// the splits in turn left 64 threads busy for the whole launch at batch 1.)
__global__ void finalize_kernel(const float* __restrict__ pmean,
                                const float* __restrict__ pm2,
                                float2* __restrict__ stats, int n, int hw,
                                int c, int chunk, int splits, float eps) {
  const int group = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (group >= n * c) return;  // uniform across the warp
  const int img = group / c, ch = group % c;
  float cnt = 0.f, mean = 0.f, m2 = 0.f;
  for (int s = lane; s < splits; s += 32) {
    const size_t off = ((size_t)img * splits + s) * c + ch;
    chan_merge(cnt, mean, m2, (float)min(chunk, hw - s * chunk), pmean[off],
               pm2[off]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, cnt, o);
    const float mb = __shfl_xor_sync(0xffffffffu, mean, o);
    const float qb = __shfl_xor_sync(0xffffffffu, m2, o);
    chan_merge(cnt, mean, m2, nb, mb, qb);
  }
  const float var = m2 / (float)hw;  // biased, as nn.InstanceNorm2d
  if (lane == 0) stats[group] = make_float2(mean, rsqrtf(var + eps));
}

// Grid-stride over 8-element vectors: y = act(((x - mean) * rstd) * w + b).
template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const float2* __restrict__ stats,
             const float* __restrict__ weight, const float* __restrict__ bias,
             T* __restrict__ y, long long total8, int hw, int c, int act,
             float slope) {
  const long long per_img = (long long)hw * c;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total8; i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 8;
    const int ch = (int)(e % c);
    const long long img = e / per_img;
    float v[8];
    load8(x + e, v);
    const float2* st = stats + img * c + ch;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float2 s = st[k];
      float z = (v[k] - s.x) * s.y;
      z = z * weight[ch + k] + bias[ch + k];
      if (act == 1) z = fmaxf(z, 0.f);
      else if (act == 2) z = z >= 0.f ? z : z * slope;
      v[k] = z;
    }
    store8(y + e, v);
  }
}

template <typename T>
int launch(const void* x, void* y, const void* weight, const void* bias,
           void* pmean, void* pm2, void* stats, int n, int hw, int c,
           int splits, int chunk, int act, float slope, float eps,
           int apply_blocks, cudaStream_t stream) {
  const dim3 sgrid(splits, (c + kTileC - 1) / kTileC, n);
  stats_kernel<T><<<sgrid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(pmean),
      static_cast<float*>(pm2), hw, c, chunk, splits);
  const long long fin_threads = 32LL * n * c;
  finalize_kernel<<<(int)((fin_threads + kThreads - 1) / kThreads), kThreads,
                    0, stream>>>(
      static_cast<const float*>(pmean), static_cast<const float*>(pm2),
      static_cast<float2*>(stats), n, hw, c, chunk, splits, eps);
  const long long total8 = (long long)n * hw * c / 8;
  apply_kernel<T><<<apply_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float2*>(stats),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<T*>(y), total8, hw, c, act, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. act: 0 none, 1 relu, 2 leaky relu.
// Scratch (float32, caller-allocated): pmean and pm2 of n*splits*c, stats of
// 2*n*c. Launches on `stream` and returns cudaGetLastError().
extern "C" int in_act_forward(const void* x, void* y, const void* weight,
                              const void* bias, void* pmean, void* pm2,
                              void* stats, int n, int hw, int c, int splits,
                              int chunk, int dtype, int act, float slope,
                              float eps, int apply_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, weight, bias, pmean, pm2, stats, n, hw,
                                 c, splits, chunk, act, slope, eps,
                                 apply_blocks, s);
  return launch<float>(x, y, weight, bias, pmean, pm2, stats, n, hw, c, splits,
                       chunk, act, slope, eps, apply_blocks, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
