// Depthwise 7x7 convolution over NCHW f32 ('SAME', stride 1, one filter a
// channel), forward and backward, hand-written for Hopper (sm_90a). It
// replaces PyTorch's conv_depthwise2d kernels in the U-Nets' ConvNeXt blocks
// (diffroll_tpu_torch/nn/unet.py). It replaces no TPU kernel: the JAX
// package leaves nn.Conv(feature_group_count=C) to XLA. The forward reads x
// and writes y; the backward reads dy and x and writes dx. Each does 49
// multiply-adds a value a pass, which at the card's f32 rate take 0.6 of the
// forward's bytes time and 0.8 of the backward's, so bytes bound both.
// PyTorch gives each output its own thread and 49 loads through the cache,
// and the weight gradient each of the C x 49 taps its own block, a serial
// pass over N x H x W that reads x and dy 49 times over.
//
// Here a block takes one plane (sample, channel), a strip of `th` output rows
// and a tile of 4 ncg columns (the whole width up to 128). It stages the
// strip's input with its 3-row and 3-column halo in shared memory, zeros
// outside the plane, in cp.async copies (16 bytes where the width allows),
// all in flight at once; the 49 taps sit in registers. Thread u < ncg th / RH
// computes RH = 8 rows x 4 columns of outputs: it walks the RH + 6 staged
// rows it needs once, three 16-byte shared loads a row, and each value loaded
// serves every tap and output row it meets from registers. The strips per
// plane come from the caller (ops/depthwise_conv.py::strip_plan), so that
// planes x strips fill the card.
//
//   fwd_kernel    y = x * w + b (cross-correlation, as F.conv2d).
//   bwd_kernel    stages dy and x: dx = dy * w turned 180 degrees (the same
//                 stencil, no bias), then each thread's 49 tap sums
//                 dy . x[h + i - 3, w + j - 3] and sum dy over its outputs, a
//                 butterfly over each warp, the warps added in order: one
//                 partial of 50 a (plane, block).
//   merge_kernel  dw[c, t] and db[c]: a channel's partials added over n, then
//                 over the plane's blocks, in order.
// Everything is f32 with FMA. No atomics: every sum runs in an order fixed by
// the shape, so a run gives the same bits as the last
// (tests/test_torch_depthwise_conv.py mirrors the order in numpy).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace drk {
namespace dw {

constexpr int K = 7;               // taps a side
constexpr int HALO = K / 2;        // 'SAME' padding
constexpr int TAPS = K * K;
constexpr int RH = 8;              // output rows a thread
constexpr int WIN = 12;            // staged values a thread reads a row: 3 float4
constexpr int PART = TAPS + 1;     // a block's partial: the taps' sums, then dy's
constexpr int VALS = 64;           // PART padded to the warp's reduce-scatter
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_GRID_Y = 65535;
constexpr unsigned FULL = 0xffffffffu;

// A launch's geometry: block (strip, tile) of a plane takes output rows
// [strip th, strip th + th) and columns [tile 4 ncg, tile 4 ncg + 4 ncg);
// its thread u < units() the RH rows from (u / ncg) RH and the 4 columns from
// 4 (u % ncg) of them. A staged tile row holds ncg + 2 float4 slots: slot s
// the columns x0 - 4 + 4 s .. + 3.
struct Geo {
  int H, W, th, strips, ncg, tiles;
  __host__ __device__ int slots() const { return ncg + 2; }
  __host__ __device__ int stride() const { return 4 * (ncg + 2); }
  __host__ __device__ int rows() const { return th + 2 * HALO; }
  __host__ __device__ int units() const { return ncg * (th / RH); }
  __host__ __device__ size_t tile_floats() const { return (size_t)rows() * stride(); }
};

// cp.async copies of 16 (or 4) bytes into shared memory; `valid` false
// copies nothing and writes zeros (`src` is then any address in the plane).
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// Every copy this thread issued has landed (the block still has to sync).
__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Stage rows r0 - 3 .. r0 + th + 2 and the tile's slots of one plane, zeros
// outside it: the block's threads take (row, slot) pairs, a row's slots side
// by side, and issue every copy before any lands. On the 16-byte path W is a
// multiple of 4, so a slot lies all inside or all outside the plane.
template <bool V4>
__device__ __forceinline__ void stage(const float* __restrict__ plane, float* tile, const Geo& g,
                                      int r0, int x0) {
  const int slots = g.slots(), rows = g.rows();
  const int across = min(slots, (int)blockDim.x), down = blockDim.x / across;
  const int t = threadIdx.x;
  if (t >= across * down) return;
  const int r_first = t / across, s_first = t - r_first * across;
  for (int r = r_first; r < rows; r += down) {
    const int gr = r0 - HALO + r;
    const bool row_in = gr >= 0 && gr < g.H;
    const float* row = plane + (size_t)(row_in ? gr : 0) * g.W;
    for (int s = s_first; s < slots; s += across) {
      const int gc = x0 - 4 + 4 * s;
      float* dst = tile + r * g.stride() + 4 * s;
      if (V4) {
        const bool in = row_in && gc >= 0 && gc < g.W;
        copy16(dst, in ? row + gc : plane, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = row_in && gc + e >= 0 && gc + e < g.W;
          copy4(dst + e, in ? row + gc + e : plane, in);
        }
      }
    }
  }
}

// Three float4 of a staged row: the 12 values a thread's 4 columns need.
__device__ __forceinline__ void window(const float* p, float (&v)[WIN]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 f = q[k];
    v[4 * k] = f.x;
    v[4 * k + 1] = f.y;
    v[4 * k + 2] = f.z;
    v[4 * k + 3] = f.w;
  }
}

// Thread unit u's RH x 4 outputs from a staged tile: out[k][q] = bias +
// sum over (i, j) in row-major order of w[i][j] tile[k + i][q + j] (the
// unit's rows and columns), written where they lie inside the plane.
template <bool V4>
__device__ __forceinline__ void stencil(const float* tile, const float (&w)[TAPS], float bias,
                                        float* __restrict__ out, const Geo& g, int r0, int x0,
                                        int u) {
  const int cg = u % g.ncg, run = u / g.ncg;
  const float* t = tile + run * RH * g.stride() + 4 * cg;
  float acc[RH][4];
#pragma unroll
  for (int k = 0; k < RH; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = bias;
#pragma unroll
  for (int r = 0; r < RH + 2 * HALO; ++r) {
    float v[WIN];
    window(t + r * g.stride(), v);
#pragma unroll
    for (int k = 0; k < RH; ++k) {
      const int i = r - k;   // the tap row staged row r is to output row k
      if (i < 0 || i >= K) continue;
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[k][q] = fmaf(w[i * K + j], v[q + j + 1], acc[k][q]);
    }
  }
  const int gc = x0 + 4 * cg;
#pragma unroll
  for (int k = 0; k < RH; ++k) {
    const int gr = r0 + run * RH + k;
    if (gr >= g.H) break;
    float* o = out + (size_t)gr * g.W + gc;
    if (V4) {
      if (gc < g.W) *reinterpret_cast<float4*>(o) = make_float4(acc[k][0], acc[k][1], acc[k][2],
                                                                acc[k][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (gc + q < g.W) o[q] = acc[k][q];
    }
  }
}

// Thread unit u's weight-gradient sums over its outputs: acc[i K + j] +=
// dy[k][q] x[k + i][q + j] over k, then q, in order; acc[TAPS] += dy[k][q].
// dy is zero past the plane's edges (staged so), so those outputs add nothing.
__device__ __forceinline__ void wgrad(const float* tile_dy, const float* tile_x, const Geo& g,
                                      int u, float (&acc)[VALS]) {
  const int cg = u % g.ncg, run = u / g.ncg;
  const int off = run * RH * g.stride() + 4 * cg;
  float d[RH][4];
#pragma unroll
  for (int k = 0; k < RH; ++k) {
    const float4 f = *reinterpret_cast<const float4*>(tile_dy + off + (k + HALO) * g.stride() + 4);
    d[k][0] = f.x;
    d[k][1] = f.y;
    d[k][2] = f.z;
    d[k][3] = f.w;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[TAPS] += d[k][q];
  }
#pragma unroll
  for (int r = 0; r < RH + 2 * HALO; ++r) {
    float v[WIN];
    window(tile_x + off + r * g.stride(), v);
#pragma unroll
    for (int k = 0; k < RH; ++k) {
      const int i = r - k;
      if (i < 0 || i >= K) continue;
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i * K + j] = fmaf(d[k][q], v[q + j + 1], acc[i * K + j]);
    }
  }
}

// One level of the warp's reduce-scatter: of v[0, 4M) a lane keeps the half
// its bit M selects, adds its partner's (lane ^ M) copy of that half, and
// holds the sums in v[0, 2M); for M = 16 the halves are v[0, 32) and
// v[32, 64).
template <int M>
__device__ __forceinline__ void scatter_level(float (&v)[VALS], int lane) {
  constexpr int HALF = 2 * M;
  const bool up = lane & M;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, M);
  }
}

// The block's sums of v[0, PART) into out, in an order the block's shape
// fixes: lanes l and l ^ 16 added, then ^ 8, .. ^ 1 (lane l ends with values
// 2l and 2l + 1), then the warps in order.
__device__ __forceinline__ void block_partial(float (&v)[VALS], float (*red)[VALS],
                                              float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  scatter_level<16>(v, lane);
  scatter_level<8>(v, lane);
  scatter_level<4>(v, lane);
  scatter_level<2>(v, lane);
  scatter_level<1>(v, lane);
  red[warp][2 * lane] = v[0];
  red[warp][2 * lane + 1] = v[1];
  __syncthreads();
  const int warps = blockDim.x >> 5;
  for (int t = threadIdx.x; t < PART; t += blockDim.x) {
    float s = red[0][t];
    for (int k = 1; k < warps; ++k) s += red[k][t];
    out[t] = s;
  }
  __syncthreads();  // red and the tiles are reused by the next plane
}

__device__ __forceinline__ void load_taps(const float* __restrict__ w, int c, bool flip,
                                          float (&taps)[TAPS]) {
#pragma unroll
  for (int t = 0; t < TAPS; ++t) taps[t] = __ldg(w + c * TAPS + (flip ? TAPS - 1 - t : t));
}

template <bool V4>
__global__ void __launch_bounds__(MAX_THREADS, 2)
fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ b, float* __restrict__ y, int C, int planes, Geo g) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int strip = blockIdx.x / g.tiles, col = blockIdx.x - strip * g.tiles;
  const int r0 = strip * g.th, x0 = col * 4 * g.ncg;
  const size_t hw = (size_t)g.H * g.W;
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    const int c = p % C;
    float taps[TAPS];
    load_taps(w, c, false, taps);
    const float bias = b != nullptr ? __ldg(b + c) : 0.f;
    stage<V4>(x + p * hw, tile, g, r0, x0);
    copies_landed();
    __syncthreads();
    if ((int)threadIdx.x < g.units()) stencil<V4>(tile, taps, bias, y + p * hw, g, r0, x0,
                                                  threadIdx.x);
    __syncthreads();
  }
}

template <bool V4>
__global__ void __launch_bounds__(MAX_THREADS, 2)
bwd_kernel(const float* __restrict__ dy, const float* __restrict__ x,
           const float* __restrict__ w, float* __restrict__ dx, float* __restrict__ part, int C,
           int planes, Geo g) {
  extern __shared__ float4 smem[];
  __shared__ float red[MAX_WARPS][VALS];
  float* tile_dy = reinterpret_cast<float*>(smem);
  float* tile_x = tile_dy + g.tile_floats();
  const int strip = blockIdx.x / g.tiles, col = blockIdx.x - strip * g.tiles;
  const int r0 = strip * g.th, x0 = col * 4 * g.ncg;
  const size_t hw = (size_t)g.H * g.W;
  const bool active = (int)threadIdx.x < g.units();
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    const int c = p % C;
    stage<V4>(dy + p * hw, tile_dy, g, r0, x0);
    stage<V4>(x + p * hw, tile_x, g, r0, x0);
    copies_landed();
    __syncthreads();
    if (active) {
      float taps[TAPS];
      load_taps(w, c, true, taps);
      stencil<V4>(tile_dy, taps, 0.f, dx + p * hw, g, r0, x0, threadIdx.x);
    }
    float acc[VALS];
#pragma unroll
    for (int t = 0; t < VALS; ++t) acc[t] = 0.f;
    if (active) wgrad(tile_dy, tile_x, g, threadIdx.x, acc);
    block_partial(acc, red, part + ((size_t)p * gridDim.x + blockIdx.x) * PART);
  }
}

// dw[c, t] (t < 49) and db[c] (t = 49): partials (n C + c, block) added over
// n, then over the blocks, in order.
__global__ void merge_kernel(const float* __restrict__ part, float* __restrict__ dw,
                             float* __restrict__ db, int N, int C, int blocks) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= C * PART) return;
  const int c = idx / PART, t = idx - c * PART;
  float s = 0.f;
  for (int n = 0; n < N; ++n) {
    const float* pp = part + (size_t)(n * C + c) * blocks * PART + t;
    for (int k = 0; k < blocks; ++k) s += pp[(size_t)k * PART];
  }
  if (t < TAPS)
    dw[c * TAPS + t] = s;
  else
    db[c] = s;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline int threads_for(const Geo& g) { return (g.units() + 31) / 32 * 32; }

inline dim3 grid_for(const Geo& g, int planes) {
  return dim3(g.strips * g.tiles, planes < MAX_GRID_Y ? planes : MAX_GRID_Y);
}

// Raise a kernel's dynamic shared memory limit to `bytes` the first time a
// launch needs more than it was given (one-time set-up, not a call a launch).
inline cudaError_t allow_smem(const void* fn, size_t bytes, size_t& set) {
  if (bytes <= set) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) set = bytes;
  return e;
}

template <class F>
inline cudaError_t by_width(bool v4, F&& f) {
  return v4 ? f(std::true_type{}) : f(std::false_type{});
}

}  // namespace dw
}  // namespace drk

extern "C" {

// y = depthwise 7x7 of x (N, C, H, W) f32, contiguous, with w (C, 49) and b
// (C, or null), zero padding 3, stride 1. (th, strips, ncg, tiles): the plan.
int drk_dwconv_fwd(const void* x, const void* w, const void* b, void* y, int N, int C, int H,
                   int W, int th, int strips, int ncg, int tiles, void* stream) {
  using namespace drk::dw;
  const Geo g{H, W, th, strips, ncg, tiles};
  const int planes = N * C;
  const size_t smem = g.tile_floats() * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v4 = W % 4 == 0 && aligned16(x) && aligned16(y);
  return (int)by_width(v4, [&](auto width) {
    constexpr bool V4 = decltype(width)::value;
    static size_t smem_set = 48 * 1024;
    cudaError_t e = allow_smem((const void*)fwd_kernel<V4>, smem, smem_set);
    if (e != cudaSuccess) return e;
    fwd_kernel<V4><<<grid_for(g, planes), threads_for(g), smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y), C, planes, g);
    return cudaGetLastError();
  });
}

// From dy and x (N, C, H, W) f32, contiguous, and w (C, 49): dx, dw (C, 49)
// and db (C). Scratch: `part`, (N C) x strips x tiles x 50 f32.
int drk_dwconv_bwd(const void* dy, const void* x, const void* w, void* dx, void* part, void* dw,
                   void* db, int N, int C, int H, int W, int th, int strips, int ncg, int tiles,
                   void* stream) {
  using namespace drk::dw;
  const Geo g{H, W, th, strips, ncg, tiles};
  const int planes = N * C;
  const size_t smem = 2 * g.tile_floats() * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v4 = W % 4 == 0 && aligned16(dy) && aligned16(x) && aligned16(dx);
  float* pp = static_cast<float*>(part);
  cudaError_t e = by_width(v4, [&](auto width) {
    constexpr bool V4 = decltype(width)::value;
    static size_t smem_set = 48 * 1024;
    cudaError_t err = allow_smem((const void*)bwd_kernel<V4>, smem, smem_set);
    if (err != cudaSuccess) return err;
    bwd_kernel<V4><<<grid_for(g, planes), threads_for(g), smem, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(x),
        static_cast<const float*>(w), static_cast<float*>(dx), pp, C, planes, g);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return (int)e;
  const int n = C * PART;
  merge_kernel<<<(n + MAX_THREADS - 1) / MAX_THREADS, MAX_THREADS, 0, st>>>(
      pp, static_cast<float*>(dw), static_cast<float*>(db), N, C, g.strips * g.tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
