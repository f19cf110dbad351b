// Fused instance norm + affine + activation, forward (kernel A) and backward
// (kernel C), for NHWC tensors on Hopper (sm_90a). Replaces the Pallas
// kernels of tactile_gan_tpu/ops/pallas/instance_norm.py: instance_norm_act
// -> _norm_call -> _kernel :104 (forward) and _bwd -> _bwd_call ->
// _bwd_kernel :233 (backward).
//
// Bound: memory. The forward reads x once and writes y once (2 accesses of
// x's size; a few flops an element); the backward reads x and g once and
// writes dx once (3 accesses). Statistics are per (image, channel) over H*W,
// and each output element needs them, so a plain design sweeps its inputs
// twice (reduce, then write): 3 and 5 accesses.
//
// Design: one persistent, cooperative launch per call (in_act_fwd_kernel,
// in_act_bwd_kernel). The grid is one 512-thread block an SM, all
// co-resident, and it walks the call's images in slabs of whole images
// (`ips` images a slab, `bpi` blocks an image, each block a contiguous
// `share` of an image's pixels with all their channels). Per slab:
//  1. each block reads its share once (16-byte vectors through registers:
//     4 float32 or 8 bf16 channels of one pixel a thread, kUnroll in
//     flight), keeps it in shared memory, and folds it into per-thread
//     partials: Welford (count, mean, M2) for A; the sums of dz and dz*xhat
//     for C, with xhat from the forward's saved (mean, rstd);
//  2. the block's threads merge their partials in a fixed tree and write one
//     partial per (block, channel) to a scratch;
//  3. grid barrier;
//  4. one warp per (image, channel) merges that channel's `bpi` partials in
//     a fixed order (Chan's merge for A: the two-pass variance to rounding,
//     never the E[x^2] - m^2 that cancels when |mean| >> std; plain sums for
//     C) and writes A's (mean, rstd) or C's per-(n, c) dscale and doffset;
//  5. grid barrier;
//  6. each block writes y (A: (x - mean) * (rstd * w) + o, one FMA, then the
//     activation) or dx (C) from its shared-memory copy.
// So x (and g) are read from device memory once, and two runs give the same
// bits (no atomics; every merge in a fixed order). What one block writes
// and another reads within the launch (partials, statistics, dscale and
// doffset) is read with plain loads after grid.sync(), which orders them,
// never through the read-only path (__ldg), which is not kept coherent
// within a launch; plain loads also let L1 serve the many threads that read
// one image's statistics (through L2 alone, all blocks of a batch-1 call
// queue on the same few lines).
//
// A share larger than shared memory: the block keeps its first `resident`
// pixels and re-reads the rest from device memory in step 6 (streamed
// first, while they may still sit in L2). On the main path (batch 1 and 4,
// 256^2 to 16^2) only C at 256^2 x 64 in float32 streams: its x and g need
// 254 KB a block where 209 KB fit, so 79 of each block's 497 pixels (16%)
// are read twice. A streams only above about 330^2 x 64 in float32.
//
// C must be a multiple of 8 and the pointers 16-byte aligned (the Python
// wrapper checks both and pads other C). The slab plan (ips, bpi, share,
// resident, shared-memory bytes) comes from launch_plan in
// ops/kernels/instance_norm.py; the launch fails, and the wrapper raises,
// when the grid cannot be co-resident.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <set>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB: a block's dynamic maximum
// 16-byte loads in flight per thread and input (2 in C on bf16: 8 channels
// a vector and two inputs spill at 4).
constexpr int kUnroll = 4;
// Step 4: a lane loads this many blocks' partials before merging them.
constexpr int kMergeLoads = 8;

// 16 bytes of T as floats (bf16 by bit shifts and one cvt per pair).
template <typename T> struct Pack;

template <> struct Pack<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static unsigned pair(float lo, float hi) {
    unsigned w;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(w) : "f"(hi), "f"(lo));
    return w;
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(pair(v[0], v[1]), pair(v[2], v[3]), pair(v[4], v[5]),
                      pair(v[6], v[7]));
  }
};

template <typename T>
__device__ __forceinline__ uint4 ldg16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ void st16(T* p, const uint4& r) {
  *reinterpret_cast<uint4*>(p) = r;
}

template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// One call's slab plan (launch_plan in ops/kernels/instance_norm.py).
struct Plan {
  int n, hw, c;
  int ips;       // images a slab
  int bpi;       // blocks an image; the grid is ips * bpi
  int share;     // pixels a block (the last block of an image may get fewer)
  int resident;  // of those, pixels kept in shared memory
};

// The thread layout of a block: thread t takes channel group
// pass * gpt + t % gpt (kVec channels) of the pixels q = lane, lane + lanes,
// ... of its share, lane = t / gpt.
struct Geom {
  int groups, gpt, lanes, passes;
  __device__ Geom(int c, int vec) {
    groups = c / vec;
    gpt = min(groups, kThreads);
    lanes = kThreads / gpt;
    passes = (groups + gpt - 1) / gpt;
  }
};

__device__ __forceinline__ int block_pixels(const Plan& p, int j) {
  return max(0, min(p.share, p.hw - j * p.share));
}

// The first pixel >= from of the lane's stride.
__device__ __forceinline__ int first_from(int from, int lane, int lanes) {
  return lane >= from ? lane : lane + (from - lane + lanes - 1) / lanes * lanes;
}

// Chan's merge of (count, mean, M2) b into a.
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& m2a,
                                           float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float n = na + nb;
  const float d = mb - ma;
  const float f = nb * __frcp_rn(n);
  ma += d * f;
  m2a += m2b + d * d * na * f;
  na = n;
}

__device__ __forceinline__ float activate(float z, int act, float slope) {
  if (act == 1) return fmaxf(z, 0.f);
  if (act == 2) return z >= 0.f ? z : z * slope;
  return z;
}

__device__ __forceinline__ float act_grad(float z, int act, float slope) {
  if (act == 1) return z > 0.f ? 1.f : 0.f;
  if (act == 2) return z >= 0.f ? 1.f : slope;
  return 1.f;
}

// Kernel A's fold of one pixel's vector into a thread's Welford state.
template <typename T>
__device__ __forceinline__ void welford(const uint4& r, float& cnt,
                                        float* mean, float* m2) {
  constexpr int V = Pack<T>::kVec;
  float v[V];
  Pack<T>::unpack(r, v);
  cnt += 1.f;
  const float inv = __frcp_rn(cnt);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float d = v[k] - mean[k];
    mean[k] += d * inv;
    m2[k] += d * (v[k] - mean[k]);
  }
}

// Kernel A's output of one vector: act((x - mean) * (rstd * w) + o).
template <typename T>
__device__ __forceinline__ uint4 norm_act(const uint4& r, const float* mean,
                                          const float* sc, const float* of,
                                          int act, float slope) {
  constexpr int V = Pack<T>::kVec;
  float v[V];
  Pack<T>::unpack(r, v);
#pragma unroll
  for (int k = 0; k < V; ++k)
    v[k] = activate(fmaf(v[k] - mean[k], sc[k], of[k]), act, slope);
  return Pack<T>::pack(v);
}

// Kernel C's per-channel constants of one thread's channel group.
template <int V>
struct GradCoef {
  float mean[V], rstd[V], sc[V], of[V];
};

// Kernel C's fold of one pixel: the sums of dz and dz * xhat.
template <typename T, int V>
__device__ __forceinline__ void grad_fold(const uint4& rx, const uint4& rg,
                                          const GradCoef<V>& k_, int act,
                                          float slope, float* sdz,
                                          float* sdzx) {
  float xv[V], gv[V];
  Pack<T>::unpack(rx, xv);
  Pack<T>::unpack(rg, gv);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float xh = (xv[k] - k_.mean[k]) * k_.rstd[k];
    const float dz = gv[k] * act_grad(fmaf(xh, k_.sc[k], k_.of[k]), act, slope);
    sdz[k] += dz;
    sdzx[k] += dz * xh;
  }
}

// Kernel C's dx of one vector: rstd * (dz*s - m1 - xhat*m2).
template <typename T, int V>
__device__ __forceinline__ uint4 grad_dx(const uint4& rx, const uint4& rg,
                                         const GradCoef<V>& k_,
                                         const float* m1, const float* m2,
                                         int act, float slope) {
  float xv[V], gv[V];
  Pack<T>::unpack(rx, xv);
  Pack<T>::unpack(rg, gv);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float xh = (xv[k] - k_.mean[k]) * k_.rstd[k];
    const float dz = gv[k] * act_grad(fmaf(xh, k_.sc[k], k_.of[k]), act, slope);
    xv[k] = k_.rstd[k] * (dz * k_.sc[k] - m1[k] - xh * m2[k]);
  }
  return Pack<T>::pack(xv);
}

// The block-wide merge of per-thread partials. red: (2 * V + 1) rows of
// kThreads floats; column t holds thread t's (count, a[V], b[V]). Lane l
// takes lane l + s for s = P/2, P/4, ..., 1 (P the power of two >= lanes):
// a fixed order. Welford (A: a = mean, b = M2) or plain sums (C: count
// unused). Every thread of the block must call it.
template <int V, bool kWelford>
__device__ __forceinline__ void block_merge(float* red, int t, int lane,
                                            const Geom& geo, bool on,
                                            float& cnt, float* a, float* b) {
  if (on) {
    red[t] = cnt;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[(1 + k) * kThreads + t] = a[k];
      red[(1 + V + k) * kThreads + t] = b[k];
    }
  }
  int pw = 1;
  while (pw < geo.lanes) pw <<= 1;
  for (int s = pw >> 1; s > 0; s >>= 1) {
    __syncthreads();
    if (on && lane < s && lane + s < geo.lanes) {
      const int u = t + s * geo.gpt;
      if (kWelford) {
        const float nb = red[u];
        if (nb > 0.f) {
          const float n = cnt + nb;
          const float f = nb * __frcp_rn(n);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float d = red[(1 + k) * kThreads + u] - a[k];
            a[k] += d * f;
            b[k] += red[(1 + V + k) * kThreads + u] + d * d * cnt * f;
          }
          cnt = n;
        }
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          a[k] += red[(1 + k) * kThreads + u];
          b[k] += red[(1 + V + k) * kThreads + u];
        }
      }
      red[t] = cnt;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        red[(1 + k) * kThreads + t] = a[k];
        red[(1 + V + k) * kThreads + t] = b[k];
      }
    }
  }
  __syncthreads();  // red is free for the next pass
}

// Step 4: lane `wl` of a warp loads the partials of blocks wl, wl + 32,
// ... of one (image, channel) (part: that channel's entry of block 0, c
// floats2 apart), kMergeLoads at a time, and merges them in that order.
template <typename Merge>
__device__ __forceinline__ void merge_blocks(const float2* part, int c,
                                             int bpi, int wl, Merge merge) {
  for (int jb = wl; jb < bpi; jb += kMergeLoads * 32) {
    float2 v[kMergeLoads];
#pragma unroll
    for (int u = 0; u < kMergeLoads; ++u) {
      const int jj = jb + 32 * u;
      v[u] = jj < bpi ? part[(size_t)jj * c] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kMergeLoads; ++u)
      if (jb + 32 * u < bpi) merge(jb + 32 * u, v[u]);
  }
}

struct FwdArgs {
  const void* x;
  void* y;
  const float* weight;
  const float* bias;
  float2* part;   // (n, bpi, c): a block's (mean, M2) of one channel
  float2* stats;  // (n, c): [mean, rstd], kept for kernel C
  Plan plan;
  int act;
  float slope, eps;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) in_act_fwd_kernel(const FwdArgs a) {
  constexpr int V = Pack<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  T* res = reinterpret_cast<T*>(smem + (2 * V + 1) * kThreads * 4);
  const Plan& p = a.plan;
  cg::grid_group grid = cg::this_grid();
  const Geom geo(p.c, V);
  const int t = threadIdx.x;
  const int gin = t % geo.gpt, lane = t / geo.gpt;
  const int slot = blockIdx.x / p.bpi, j = blockIdx.x % p.bpi;
  const int q0 = j * p.share;
  const int count = block_pixels(p, j);
  const int res_n = min(count, p.resident);
  const int first_streamed = first_from(res_n, lane, geo.lanes);
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);

  for (int img0 = 0; img0 < p.n; img0 += p.ips) {
    const int img = img0 + slot;
    const bool live = img < p.n;  // the last slab may hold fewer images
    const size_t base = ((size_t)img * p.hw + q0) * p.c;
    // 1-2: read the share once, keep it, fold it into the block's partials.
    if (live) {
      for (int pass = 0; pass < geo.passes; ++pass) {
        const int c0 = (pass * geo.gpt + gin) * V;
        const bool on = lane < geo.lanes && c0 < p.c;
        float cnt = 0.f, mean[V], m2[V];
#pragma unroll
        for (int k = 0; k < V; ++k) mean[k] = m2[k] = 0.f;
        if (on) {
          const T* src = x + base + c0;
          for (int q = lane; q < count; q += kUnroll * geo.lanes) {
            uint4 r[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int qu = q + u * geo.lanes;
              if (qu < count) r[u] = ldg16(src + (size_t)qu * p.c);
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int qu = q + u * geo.lanes;
              if (qu < count) {
                if (qu < res_n) st16(res + qu * p.c + c0, r[u]);
                welford<T>(r[u], cnt, mean, m2);
              }
            }
          }
        }
        block_merge<V, true>(red, t, lane, geo, on, cnt, mean, m2);
        if (on && lane == 0) {
          float2* dst = a.part + ((size_t)img * p.bpi + j) * p.c + c0;
#pragma unroll
          for (int k = 0; k < V; ++k) dst[k] = make_float2(mean[k], m2[k]);
        }
      }
    }
    grid.sync();
    // 4: one warp per (image, channel) of the slab merges its bpi partials;
    // items go to the blocks in turn, so a narrow slab uses a warp an SM.
    {
      const int items = min(p.ips, p.n - img0) * p.c;
      const int wl = t & 31;
      for (int item = t / 32 * gridDim.x + blockIdx.x; item < items;
           item += gridDim.x * (kThreads / 32)) {
        const int im = img0 + item / p.c, ch = item % p.c;
        float n = 0.f, m = 0.f, q = 0.f;
        merge_blocks(a.part + (size_t)im * p.bpi * p.c + ch, p.c, p.bpi, wl,
                     [&](int jj, float2 v) {
                       chan_merge(n, m, q, (float)block_pixels(p, jj), v.x, v.y);
                     });
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float nb = __shfl_xor_sync(0xffffffffu, n, o);
          const float mb = __shfl_xor_sync(0xffffffffu, m, o);
          const float qb = __shfl_xor_sync(0xffffffffu, q, o);
          chan_merge(n, m, q, nb, mb, qb);
        }
        if (wl == 0)  // biased variance, as nn.InstanceNorm2d
          a.stats[(size_t)im * p.c + ch] =
              make_float2(m, rsqrtf(q / (float)p.hw + a.eps));
      }
    }
    grid.sync();
    // 6: y from the kept copy; the streamed part first.
    if (live) {
      for (int pass = 0; pass < geo.passes; ++pass) {
        const int c0 = (pass * geo.gpt + gin) * V;
        if (!(lane < geo.lanes && c0 < p.c)) continue;
        float mean[V], sc[V], of[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float2 st = a.stats[(size_t)img * p.c + c0 + k];
          mean[k] = st.x;
          sc[k] = st.y * __ldg(a.weight + c0 + k);
          of[k] = __ldg(a.bias + c0 + k);
        }
        const T* src = x + base + c0;
        T* dst = y + base + c0;
        for (int q = first_streamed; q < count; q += kUnroll * geo.lanes) {
          uint4 r[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int qu = q + u * geo.lanes;
            if (qu < count) r[u] = ldg16(src + (size_t)qu * p.c);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int qu = q + u * geo.lanes;
            if (qu < count)
              st16(dst + (size_t)qu * p.c,
                   norm_act<T>(r[u], mean, sc, of, a.act, a.slope));
          }
        }
        for (int q = lane; q < res_n; q += geo.lanes)
          st16(dst + (size_t)q * p.c,
               norm_act<T>(ld16(res + q * p.c + c0), mean, sc, of, a.act,
                           a.slope));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel C: the closed-form backward. With xhat = (x - mean) * rstd,
// z = xhat * s + o and dz = g * act'(z) (act' from the sign of z, as the
// Pallas kernel reads it):
//   dscale[n,c] = sum_hw dz * xhat,  doffset[n,c] = sum_hw dz,
//   dx = rstd * (dz*s - mean_hw(dz*s) - xhat * mean_hw(dz*s * xhat)).
// The same slab walk as the forward, with x and g both kept.
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void* x;
  const void* g;
  void* dx;
  const float2* stats;  // (n, c): the forward's [mean, rstd]
  const float* weight;
  const float* bias;
  float2* part;  // (n, bpi, c): a block's (sum dz, sum dz*xhat) of a channel
  float* dso;    // (2, n, c): dscale, then doffset
  Plan plan;
  int act;
  float slope;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) in_act_bwd_kernel(const BwdArgs a) {
  constexpr int V = Pack<T>::kVec;
  constexpr int kU = sizeof(T) == 2 ? 2 : kUnroll;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  const Plan& p = a.plan;
  T* res_x = reinterpret_cast<T*>(smem + (2 * V + 1) * kThreads * 4);
  T* res_g = res_x + (size_t)p.resident * p.c;
  cg::grid_group grid = cg::this_grid();
  const Geom geo(p.c, V);
  const int t = threadIdx.x;
  const int gin = t % geo.gpt, lane = t / geo.gpt;
  const int slot = blockIdx.x / p.bpi, j = blockIdx.x % p.bpi;
  const int q0 = j * p.share;
  const int count = block_pixels(p, j);
  const int res_n = min(count, p.resident);
  const int first_streamed = first_from(res_n, lane, geo.lanes);
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);
  float* dscale = a.dso;
  float* doffset = a.dso + (size_t)p.n * p.c;

  for (int img0 = 0; img0 < p.n; img0 += p.ips) {
    const int img = img0 + slot;
    const bool live = img < p.n;
    const size_t base = ((size_t)img * p.hw + q0) * p.c;
    if (live) {
      for (int pass = 0; pass < geo.passes; ++pass) {
        const int c0 = (pass * geo.gpt + gin) * V;
        const bool on = lane < geo.lanes && c0 < p.c;
        float cnt = 0.f, sdz[V], sdzx[V];
#pragma unroll
        for (int k = 0; k < V; ++k) sdz[k] = sdzx[k] = 0.f;
        if (on) {
          const T* sx = x + base + c0;
          const T* sg = g + base + c0;
          GradCoef<V> k_;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float2 st = __ldg(a.stats + (size_t)img * p.c + c0 + k);
            k_.mean[k] = st.x;
            k_.rstd[k] = st.y;
            k_.sc[k] = __ldg(a.weight + c0 + k);
            k_.of[k] = __ldg(a.bias + c0 + k);
          }
          for (int q = lane; q < count; q += kU * geo.lanes) {
            uint4 rx[kU], rg[kU];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              const int qu = q + u * geo.lanes;
              if (qu < count) {
                rx[u] = ldg16(sx + (size_t)qu * p.c);
                rg[u] = ldg16(sg + (size_t)qu * p.c);
              }
            }
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              const int qu = q + u * geo.lanes;
              if (qu < count) {
                if (qu < res_n) {
                  st16(res_x + qu * p.c + c0, rx[u]);
                  st16(res_g + qu * p.c + c0, rg[u]);
                }
                grad_fold<T, V>(rx[u], rg[u], k_, a.act, a.slope, sdz, sdzx);
              }
            }
          }
        }
        block_merge<V, false>(red, t, lane, geo, on, cnt, sdz, sdzx);
        if (on && lane == 0) {
          float2* dst = a.part + ((size_t)img * p.bpi + j) * p.c + c0;
#pragma unroll
          for (int k = 0; k < V; ++k) dst[k] = make_float2(sdz[k], sdzx[k]);
        }
      }
    }
    grid.sync();
    {
      const int items = min(p.ips, p.n - img0) * p.c;
      const int wl = t & 31;
      for (int item = t / 32 * gridDim.x + blockIdx.x; item < items;
           item += gridDim.x * (kThreads / 32)) {
        const int im = img0 + item / p.c, ch = item % p.c;
        float sa = 0.f, sb = 0.f;
        merge_blocks(a.part + (size_t)im * p.bpi * p.c + ch, p.c, p.bpi, wl,
                     [&](int, float2 v) {
                       sa += v.x;
                       sb += v.y;
                     });
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          sa += __shfl_xor_sync(0xffffffffu, sa, o);
          sb += __shfl_xor_sync(0xffffffffu, sb, o);
        }
        if (wl == 0) {
          dscale[(size_t)im * p.c + ch] = sb;
          doffset[(size_t)im * p.c + ch] = sa;
        }
      }
    }
    grid.sync();
    if (live) {
      for (int pass = 0; pass < geo.passes; ++pass) {
        const int c0 = (pass * geo.gpt + gin) * V;
        if (!(lane < geo.lanes && c0 < p.c)) continue;
        // (m1, m2) = (mean_hw(dz*s), mean_hw(dz*s*xhat)) of each channel.
        GradCoef<V> k_;
        float m1[V], m2[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const size_t nc = (size_t)img * p.c + c0 + k;
          const float2 st = __ldg(a.stats + nc);
          k_.mean[k] = st.x;
          k_.rstd[k] = st.y;
          k_.sc[k] = __ldg(a.weight + c0 + k);
          k_.of[k] = __ldg(a.bias + c0 + k);
          m1[k] = doffset[nc] * k_.sc[k] / (float)p.hw;
          m2[k] = dscale[nc] * k_.sc[k] / (float)p.hw;
        }
        const T* sx = x + base + c0;
        const T* sg = g + base + c0;
        T* dst = dx + base + c0;
        for (int q = first_streamed; q < count; q += kU * geo.lanes) {
          uint4 rx[kU], rg[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int qu = q + u * geo.lanes;
            if (qu < count) {
              rx[u] = ldg16(sx + (size_t)qu * p.c);
              rg[u] = ldg16(sg + (size_t)qu * p.c);
            }
          }
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int qu = q + u * geo.lanes;
            if (qu < count)
              st16(dst + (size_t)qu * p.c,
                   grad_dx<T, V>(rx[u], rg[u], k_, m1, m2, a.act, a.slope));
          }
        }
        for (int q = lane; q < res_n; q += geo.lanes)
          st16(dst + (size_t)q * p.c,
               grad_dx<T, V>(ld16(res_x + q * p.c + c0),
                             ld16(res_g + q * p.c + c0), k_, m1, m2, a.act,
                             a.slope));
      }
    }
  }
}

// Blocks of `kernel` that fit on the card at once with `smem` bytes of
// dynamic shared memory. The first query of a kernel on a device raises its
// dynamic shared-memory limit to the block maximum; results are cached.
int co_resident_blocks(const void* kernel, int smem, int* out) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> configured;
  static std::map<std::pair<std::pair<const void*, int>, int>, int> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(kernel, dev);
  const auto hit = cache.find(std::make_pair(key, smem));
  if (hit != cache.end()) {
    *out = hit->second;
    return 0;
  }
  if (!configured.count(key)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured.insert(key);
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *out = cache[std::make_pair(key, smem)] = per_sm * sms;
  return 0;
}

// One cooperative launch of ips * bpi blocks, refused (with the CUDA error
// the launch itself would give) when the grid cannot be co-resident or the
// shared memory cannot hold the plan's resident pixels.
template <typename Args>
int launch(void (*kernel)(Args), Args args, int vec, int inputs, int itemsize,
           int smem, cudaStream_t stream) {
  const Plan& p = args.plan;
  const long long need = (long long)(2 * vec + 1) * kThreads * 4 +
                         (long long)p.resident * p.c * itemsize * inputs;
  if (p.c % 8 || smem < need || smem > kMaxSmem || p.ips < 1 || p.bpi < 1 ||
      (long long)p.bpi * p.share < p.hw)
    return (int)cudaErrorInvalidValue;
  const int grid = p.ips * p.bpi;
  int capacity = 0;
  const int err = co_resident_blocks((const void*)kernel, smem, &capacity);
  if (err) return err;
  if (grid > capacity) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&args};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                          dim3(kThreads), params, smem, stream);
}

}  // namespace

// Kernel A. dtype: 0 float32, 1 bfloat16. act: 0 none, 1 relu, 2 leaky relu.
// part: float32 scratch of 2 * n * bpi * c (caller-allocated, no zeroing);
// stats receives (n, c, 2) [mean, rstd]. One launch on `stream`; returns its
// CUDA error code.
extern "C" int in_act_forward(const void* x, void* y, const void* weight,
                              const void* bias, void* part, void* stats, int n,
                              int hw, int c, int ips, int bpi, int share,
                              int resident, int smem, int dtype, int act,
                              float slope, float eps, void* stream) {
  FwdArgs a{x, y, static_cast<const float*>(weight),
            static_cast<const float*>(bias), static_cast<float2*>(part),
            static_cast<float2*>(stats), Plan{n, hw, c, ips, bpi, share,
                                              resident},
            act, slope, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch(in_act_fwd_kernel<__nv_bfloat16>, a, 8, 1, 2, smem, s);
  return launch(in_act_fwd_kernel<float>, a, 4, 1, 4, smem, s);
}

// Kernel C. x, g and dx share `dtype`; stats is the forward's (mean, rstd)
// per (n, c). part: float32 scratch of 2 * n * bpi * c; dso (2 * n * c)
// receives per-(n, c) dscale then doffset. One launch on `stream`; returns
// its CUDA error code.
extern "C" int in_act_backward(const void* x, const void* g, void* dx,
                               const void* stats, const void* weight,
                               const void* bias, void* part, void* dso, int n,
                               int hw, int c, int ips, int bpi, int share,
                               int resident, int smem, int dtype, int act,
                               float slope, void* stream) {
  BwdArgs a{x, g, dx, static_cast<const float2*>(stats),
            static_cast<const float*>(weight), static_cast<const float*>(bias),
            static_cast<float2*>(part), static_cast<float*>(dso),
            Plan{n, hw, c, ips, bpi, share, resident}, act, slope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch(in_act_bwd_kernel<__nv_bfloat16>, a, 8, 2, 2, smem, s);
  return launch(in_act_bwd_kernel<float>, a, 4, 2, 4, smem, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
