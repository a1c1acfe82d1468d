// GroupNorm over NCHW f32, forward and backward, hand-written for Hopper
// (sm_90a). It replaces PyTorch's GroupNorm kernels in the U-Nets
// (diffroll_tpu_torch/nn/unet.py), whose norms mostly have one group: there
// PyTorch reduces each (sample, group) row in one thread block, so a batch
// of 16 keeps 16 of the card's 132 SMs busy with a serial pass over up to
// 3.2 M values each. Here every reduction is split over the whole grid. It
// replaces no TPU kernel: the JAX package leaves GroupNorm to XLA. A norm does
// a few operations a value, so bytes bound it on this card: the forward reads
// x twice and writes y, the backward reads dy and x twice and writes dx.
//
// A row is one (sample, group): D = C / G channels x HW positions, L = D HW
// values, contiguous in NCHW. A plane is one (sample, channel): HW values.
// The split plan comes from the caller (ops/group_norm.py::split_plan, which
// also mirrors the reductions in numpy): a launch over R rows (or planes) of
// length L runs `splits` blocks a row, block k taking values
// [k chunk, (k+1) chunk) of it, chunk a multiple of 4.
//
// Forward, three launches:
//   stats_kernel     each thread runs Welford over groups of 4 values (one
//                    16-byte load each; thread t takes groups t, t + 256, ...
//                    of the block's chunk), merged by Chan's formula; then
//                    a shuffle tree in each warp and a tree over the block's
//                    8 warps; one (count, mean, M2) partial per block.
//   finalize_kernel  one warp a row merges the row's partials (lane j takes
//                    partials j, j + 32, ... in order, then the shuffle tree)
//                    into mean and rstd = 1 / sqrt(M2 / L + eps): biased
//                    variance, as nn.GroupNorm's.
//   apply_kernel     y = x a + b over a plane's chunk, a = gamma rstd and
//                    b = beta - mean a once a block; the planes in reverse,
//                    so the first blocks read what stats_kernel read last
//                    (still in the L2).
// Backward, four launches, with PyTorch's formula
// (native_group_norm_backward):
//   sums_kernel      per plane, split the same way: sum dy and sum dy x.
//   coef_kernel      one block a row: each channel's partials added in
//                    order (ds, db), then sum1 = sum ds gamma and sum2 =
//                    sum db gamma over the row's channels by a tree, and
//                    c2 = (sum2 mean - sum1) rstd^3 / (D HW),
//                    c3 = -c2 mean - sum2 rstd / (D HW).
//   dparams_kernel   dgamma[c] = sum_n (ds - db mean) rstd, dbeta[c] =
//                    sum_n db, over n in order.
//   dx_kernel        dx = rstd gamma dy + c2 x + c3 over a plane's chunk,
//                    the planes in reverse, as apply_kernel's.
// Everything is f32. No atomics: every sum runs in an order fixed by the
// shape, so a run gives the same bits as the last. Loads and stores are 16
// bytes wide where HW and the chunks are multiples of 4 and every pointer is
// 16-byte aligned, else the same groups of 4 are read one value at a time.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace drk {
namespace gn {

constexpr int THREADS = 256;         // a block: 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;            // 16-byte loads a thread issues before using any
constexpr int MAX_GRID_Y = 65535;
constexpr unsigned FULL = 0xffffffffu;

struct Stat {
  float n, mean, m2;
};

// Chan's merge of two (count, mean, M2); an empty side leaves the other's
// bits as they are.
__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  const float n = a.n + b.n;
  const float f = n > 0.f ? b.n / n : 0.f;
  const float d = b.mean - a.mean;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

// The first m (1..4) values of v as a (count, mean, M2).
__device__ __forceinline__ Stat group_stat(float4 v, int m) {
  float s = v.x;
  if (m > 1) s += v.y;
  if (m > 2) s += v.z;
  if (m > 3) s += v.w;
  const float mean = s / (float)m;
  float d = v.x - mean;
  float m2 = d * d;
  if (m > 1) { d = v.y - mean; m2 += d * d; }
  if (m > 2) { d = v.z - mean; m2 += d * d; }
  if (m > 3) { d = v.w - mean; m2 += d * d; }
  return {(float)m, mean, m2};
}

template <bool V4>
__device__ __forceinline__ float4 load4(const float* p, int m) {
  if (V4) return *reinterpret_cast<const float4*>(p);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = p[0];
  if (m > 1) v.y = p[1];
  if (m > 2) v.z = p[2];
  if (m > 3) v.w = p[3];
  return v;
}

template <bool V4>
__device__ __forceinline__ void store4(float* p, float4 v, int m) {
  if (V4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (m > 1) p[1] = v.y;
  if (m > 2) p[2] = v.z;
  if (m > 3) p[3] = v.w;
}

__device__ __forceinline__ Stat shfl_down(Stat s, int off) {
  return {__shfl_down_sync(FULL, s.n, off), __shfl_down_sync(FULL, s.mean, off),
          __shfl_down_sync(FULL, s.m2, off)};
}

// Lane 0 gets the warp's merge: lane i takes lane i + off, off = 16 .. 1.
__device__ __forceinline__ Stat warp_merge(Stat s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = merge(s, shfl_down(s, off));
  return s;
}

// Thread 0 gets the block's merge: each warp's tree, then the 8 warps'
// results by the same tree (lanes 8..31 empty).
__device__ Stat block_merge(Stat s) {
  __shared__ Stat warp_stat[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_merge(s);
  if (lane == 0) warp_stat[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < WARPS ? warp_stat[lane] : Stat{0.f, 0.f, 0.f};
    s = warp_merge(s);
  }
  __syncthreads();  // warp_stat is reused by the next row
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

// Thread 0 gets the block's sums of a and b, by the trees of block_merge.
__device__ float2 block_sum2(float a, float b) {
  __shared__ float2 warp_part[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) warp_part[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    const float2 p = lane < WARPS ? warp_part[lane] : make_float2(0.f, 0.f);
    a = warp_sum(p.x);
    b = warp_sum(p.y);
  }
  __syncthreads();
  return make_float2(a, b);
}

// ------------------------------------------------------------------ forward

// On the 16-byte path every group holds 4 values, so before a thread's k-th
// group its count is 4k and merge()'s two quotients are s / 4 = s * 0.25 and
// 4 / (4k + 4) = 1 / (k + 1), both correctly rounded: the same bits without
// a division on the data's path.
__device__ __forceinline__ Stat merge_group4(Stat a, float4 v, int k) {
  const float mean = (((v.x + v.y) + v.z) + v.w) * 0.25f;
  float d = v.x - mean;
  float m2 = d * d;
  d = v.y - mean; m2 += d * d;
  d = v.z - mean; m2 += d * d;
  d = v.w - mean; m2 += d * d;
  const float f = __frcp_rn((float)(k + 1));
  d = mean - a.mean;
  return {a.n + 4.f, a.mean + d * f, a.m2 + m2 + d * d * a.n * f};
}

template <bool V4>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const float* __restrict__ x, float4* __restrict__ part, long long L,
             long long chunk, int rows) {
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = min(L, c0 + chunk);
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* xr = x + (size_t)row * L;
    Stat s{0.f, 0.f, 0.f};
    int k = 0;  // groups merged so far (16-byte path)
    for (long long i = c0 + 4LL * threadIdx.x; i < c1; i += 4LL * THREADS * UNROLL) {
      float4 v[UNROLL];
      int m[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long j = i + 4LL * THREADS * u;
        m[u] = j < c1 ? (V4 ? 4 : (int)min(4LL, c1 - j)) : 0;
        if (m[u]) v[u] = load4<V4>(xr + j, m[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!m[u]) continue;
        if (V4)
          s = merge_group4(s, v[u], k++);
        else
          s = merge(s, group_stat(v[u], m[u]));
      }
    }
    s = block_merge(s);
    if (threadIdx.x == 0)
      part[(size_t)row * gridDim.x + blockIdx.x] = make_float4(s.n, s.mean, s.m2, 0.f);
  }
}

__global__ void __launch_bounds__(THREADS)
finalize_kernel(const float4* __restrict__ part, float* __restrict__ mean,
                float* __restrict__ rstd, int splits, int rows, long long L, float eps) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  Stat s{0.f, 0.f, 0.f};
  for (int k = lane; k < splits; k += 32) {
    const float4 p = part[(size_t)row * splits + k];
    s = merge(s, Stat{p.x, p.y, p.z});
  }
  s = warp_merge(s);
  if (lane == 0) {
    mean[row] = s.mean;
    rstd[row] = 1.f / sqrtf(s.m2 / (float)L + eps);
  }
}

template <bool V4>
__global__ void __launch_bounds__(THREADS)
apply_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
             const float* __restrict__ beta, const float* __restrict__ mean,
             const float* __restrict__ rstd, float* __restrict__ y, int C, int D, long long HW,
             long long chunk, int planes) {
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = min(HW, c0 + chunk);
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    const int plane = planes - 1 - p;  // the last planes first: stats_kernel left them in L2
    const int c = plane % C, row = plane / D;
    const float a = gamma[c] * rstd[row];
    const float b = beta[c] - mean[row] * a;
    const float* xp = x + (size_t)plane * HW;
    float* yp = y + (size_t)plane * HW;
    for (long long i = c0 + 4LL * threadIdx.x; i < c1; i += 4LL * THREADS * UNROLL) {
      float4 v[UNROLL];
      int m[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long j = i + 4LL * THREADS * u;
        m[u] = j < c1 ? (int)min(4LL, c1 - j) : 0;
        if (m[u]) v[u] = load4<V4>(xp + j, m[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!m[u]) continue;
        v[u].x = fmaf(v[u].x, a, b);
        v[u].y = fmaf(v[u].y, a, b);
        v[u].z = fmaf(v[u].z, a, b);
        v[u].w = fmaf(v[u].w, a, b);
        store4<V4>(yp + i + 4LL * THREADS * u, v[u], m[u]);
      }
    }
  }
}

// ------------------------------------------------------------------ backward

template <bool V4>
__global__ void __launch_bounds__(THREADS)
sums_kernel(const float* __restrict__ dy, const float* __restrict__ x,
            float2* __restrict__ part, long long HW, long long chunk, int planes) {
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = min(HW, c0 + chunk);
  for (int plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const float* gp = dy + (size_t)plane * HW;
    const float* xp = x + (size_t)plane * HW;
    float sdy = 0.f, sdyx = 0.f;
    for (long long i = c0 + 4LL * threadIdx.x; i < c1; i += 4LL * THREADS * UNROLL) {
      float4 g[UNROLL], v[UNROLL];
      int m[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long j = i + 4LL * THREADS * u;
        m[u] = j < c1 ? (int)min(4LL, c1 - j) : 0;
        if (m[u]) {
          g[u] = load4<V4>(gp + j, m[u]);
          v[u] = load4<V4>(xp + j, m[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!m[u]) continue;
        sdy += (g[u].x + g[u].y) + (g[u].z + g[u].w);  // the loads fill past m with 0
        sdyx += (g[u].x * v[u].x + g[u].y * v[u].y) + (g[u].z * v[u].z + g[u].w * v[u].w);
      }
    }
    const float2 s = block_sum2(sdy, sdyx);
    if (threadIdx.x == 0) part[(size_t)plane * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
coef_kernel(const float2* __restrict__ part, const float* __restrict__ gamma,
            const float* __restrict__ mean, const float* __restrict__ rstd,
            float2* __restrict__ dsdb, float2* __restrict__ c23, int G, int D, long long HW,
            int splits) {
  const int row = blockIdx.x, n = row / G, g = row % G, C = G * D;
  float sum1 = 0.f, sum2 = 0.f;
  for (int r = threadIdx.x; r < D; r += THREADS) {
    const int c = g * D + r, plane = n * C + c;
    float db = 0.f, ds = 0.f;
    for (int k = 0; k < splits; ++k) {
      const float2 p = part[(size_t)plane * splits + k];
      db += p.x;
      ds += p.y;
    }
    dsdb[plane] = make_float2(ds, db);
    sum1 += ds * gamma[c];
    sum2 += db * gamma[c];
  }
  const float2 s = block_sum2(sum1, sum2);
  if (threadIdx.x == 0) {
    const float inv = 1.f / ((float)D * (float)HW);
    const float mu = mean[row], rs = rstd[row];
    const float c2 = (s.y * mu - s.x) * rs * rs * rs * inv;
    c23[row] = make_float2(c2, -c2 * mu - s.y * rs * inv);
  }
}

__global__ void __launch_bounds__(THREADS)
dparams_kernel(const float2* __restrict__ dsdb, const float* __restrict__ mean,
               const float* __restrict__ rstd, float* __restrict__ dgamma,
               float* __restrict__ dbeta, int N, int C, int D) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const int G = C / D;
  float dg = 0.f, dbt = 0.f;
  for (int n = 0; n < N; ++n) {
    const float2 p = dsdb[(size_t)n * C + c];
    const int row = n * G + c / D;
    dg += (p.x - p.y * mean[row]) * rstd[row];
    dbt += p.y;
  }
  dgamma[c] = dg;
  dbeta[c] = dbt;
}

template <bool V4>
__global__ void __launch_bounds__(THREADS)
dx_kernel(const float* __restrict__ dy, const float* __restrict__ x,
          const float* __restrict__ gamma, const float* __restrict__ rstd,
          const float2* __restrict__ c23, float* __restrict__ dx, int C, int D, long long HW,
          long long chunk, int planes) {
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = min(HW, c0 + chunk);
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    const int plane = planes - 1 - p;  // the last planes first: sums_kernel left them in L2
    const int c = plane % C, row = plane / D;
    const float c1s = rstd[row] * gamma[c];
    const float2 k = c23[row];
    const float* gp = dy + (size_t)plane * HW;
    const float* xp = x + (size_t)plane * HW;
    float* op = dx + (size_t)plane * HW;
    for (long long i = c0 + 4LL * threadIdx.x; i < c1; i += 4LL * THREADS * UNROLL) {
      float4 g[UNROLL], v[UNROLL];
      int m[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long j = i + 4LL * THREADS * u;
        m[u] = j < c1 ? (int)min(4LL, c1 - j) : 0;
        if (m[u]) {
          g[u] = load4<V4>(gp + j, m[u]);
          v[u] = load4<V4>(xp + j, m[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!m[u]) continue;
        float4 o;
        o.x = c1s * g[u].x + k.x * v[u].x + k.y;
        o.y = c1s * g[u].y + k.x * v[u].y + k.y;
        o.z = c1s * g[u].z + k.x * v[u].z + k.y;
        o.w = c1s * g[u].w + k.x * v[u].w + k.y;
        store4<V4>(op + i + 4LL * THREADS * u, o, m[u]);
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline dim3 split_grid(int splits, int rows) {
  return dim3(splits, rows < MAX_GRID_Y ? rows : MAX_GRID_Y);
}

// f(std::true_type) where the 16-byte path applies, else f(std::false_type):
// one launch site for both instances of a kernel.
template <class F>
inline void by_width(bool v4, F&& f) {
  if (v4)
    f(std::true_type{});
  else
    f(std::false_type{});
}

}  // namespace gn
}  // namespace drk

extern "C" {

// GroupNorm forward over x (N, C, HW) f32, contiguous: y, and mean and rstd
// (N * G) for the backward. `part` holds (N G) x `splits` float4 partials;
// a row's blocks take `chunk` values each; the planes' launch takes
// `psplits` blocks of `pchunk` values a plane.
int drk_group_norm_fwd(const void* x, const void* gamma, const void* beta, void* y, void* mean,
                       void* rstd, void* part, int N, int C, int HW, int G, float eps,
                       int splits, int chunk, int psplits, int pchunk, void* stream) {
  using namespace drk::gn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = C / G, rows = N * G, planes = N * C;
  const long long L = (long long)D * HW;
  const float* xf = static_cast<const float*>(x);
  float4* pp = static_cast<float4*>(part);
  float *mu = static_cast<float*>(mean), *rs = static_cast<float*>(rstd);
  const bool v4 = HW % 4 == 0 && chunk % 4 == 0 && pchunk % 4 == 0 && aligned16(x) &&
                  aligned16(y);
  const float *ga = static_cast<const float*>(gamma), *be = static_cast<const float*>(beta);
  float* yf = static_cast<float*>(y);
  by_width(v4, [&](auto w) {
    constexpr bool V4 = decltype(w)::value;
    stats_kernel<V4><<<split_grid(splits, rows), THREADS, 0, st>>>(xf, pp, L, chunk, rows);
    finalize_kernel<<<(rows + WARPS - 1) / WARPS, THREADS, 0, st>>>(pp, mu, rs, splits, rows,
                                                                    L, eps);
    apply_kernel<V4><<<split_grid(psplits, planes), THREADS, 0, st>>>(
        xf, ga, be, mu, rs, yf, C, D, HW, pchunk, planes);
  });
  return (int)cudaGetLastError();
}

// GroupNorm backward from dy, x (N, C, HW) and the forward's mean and rstd:
// dx, dgamma and dbeta (C). Scratch: `part` (N C) x `psplits` float2, `dsdb`
// (N C) float2, `c23` (N G) float2.
int drk_group_norm_bwd(const void* dy, const void* x, const void* gamma, const void* mean,
                       const void* rstd, void* dx, void* dgamma, void* dbeta, void* part,
                       void* dsdb, void* c23, int N, int C, int HW, int G, int psplits,
                       int pchunk, void* stream) {
  using namespace drk::gn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = C / G, rows = N * G, planes = N * C;
  const float *g = static_cast<const float*>(dy), *xf = static_cast<const float*>(x);
  const float *ga = static_cast<const float*>(gamma), *mu = static_cast<const float*>(mean),
              *rs = static_cast<const float*>(rstd);
  float2 *pp = static_cast<float2*>(part), *sd = static_cast<float2*>(dsdb),
         *cc = static_cast<float2*>(c23);
  const bool v4 = HW % 4 == 0 && pchunk % 4 == 0 && aligned16(dy) && aligned16(x) &&
                  aligned16(dx);
  float* o = static_cast<float*>(dx);
  by_width(v4, [&](auto w) {
    constexpr bool V4 = decltype(w)::value;
    sums_kernel<V4><<<split_grid(psplits, planes), THREADS, 0, st>>>(g, xf, pp, HW, pchunk,
                                                                     planes);
    coef_kernel<<<rows, THREADS, 0, st>>>(pp, ga, mu, rs, sd, cc, G, D, HW, psplits);
    dparams_kernel<<<(C + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        sd, mu, rs, static_cast<float*>(dgamma), static_cast<float*>(dbeta), N, C, D);
    dx_kernel<V4><<<split_grid(psplits, planes), THREADS, 0, st>>>(g, xf, ga, rs, cc, o, C, D,
                                                                   HW, pchunk, planes);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
