// Gated dilated-conv residual stack, hand-written for Hopper (sm_90a).
//
// Replaces diffroll_tpu/ops/gated_stack.py::gated_stack_pallas (the Pallas
// TPU kernel; body `_kernel`). Per layer l, over rows m = b*T + t:
//   y    = x + tb[l, b]                                  (rounded to bf16)
//   a    = sum_j shift(y, (j - k/2) * d_l) @ Wd[l, j] + cond @ Wc[l] + b[l] + bc[l]
//   g    = sigmoid(a[:, :C]) * tanh(a[:, C:])
//   out  = g @ Wo[l] + bo[l]
//   x    = (x + out[:, :C]) / sqrt(2)                    (kept in bf16)
//   skip = skip + out[:, C:]                              (f32)
// and the last layer scales skip by 1/sqrt(L).
//
// Form: each layer is two launches of the TMA + wgmma tile GEMM of
// gemm_sm90.cuh.
//   (a) gate_kernel: K runs over the 3 taps x C and then over the 256
//       zero-padded conditioner lanes (K1 alone and the training forward; the
//       sampler adds the hoisted f32 `rowbias` in the epilogue instead). The
//       taps are the same (channels, frames, sequence) box of y = bf16(x + tb)
//       at frame t0 + (j - k/2) * d, zero-filled by the copy outside the
//       sequence. The epilogue adds the biases and writes
//       g = sigmoid * tanh as bf16 (and, under SAVE, the pre-gate a).
//   (b) out_kernel: g @ Wo with the residual and skip updates in its
//       epilogue, which also writes the next layer's y; prep_kernel writes
//       layer 0's.
// The TPU kernel's roll/static-shift machinery, batch tiling and VMEM limit
// have no counterpart: a tile belongs to one sequence and the tensor map
// clips its taps.
//
// Bound on this card: operations. One classifier-free-guidance step of the
// flagship (B=1 -> 2 streams x 640 frames, C=512, L=15) is ~80 GFLOP over
// ~63 MB of bf16 weights, ~1,280 FLOP per byte, well above the H100's ~295
// FLOP/byte ridge. So every product runs on the tensor cores at the rate only
// wgmma reaches (bf16 operands from shared memory, f32 sums in registers),
// the operands arrive by TMA with no per-thread address arithmetic and no
// block-wide barrier in the k loop, and the gate, residual and skip updates
// are finished from the accumulator registers: no f32 (M, 2C) pre-activation
// is ever written to device memory and the f32 tile makes no round trip
// through shared memory.
//
// Filling 132 SMs: a tile is 128 frames of one sequence x one pair of 64
// columns, and the tile list is (sequence, frame tile, column pair); the
// wrapper's `stack_tiles` / `tile_waves` (ops/gated_stack.py) lay it out the
// same way. The flagship (T=640, C=512) gives 5 x 8 = 40 tiles a sequence:
//   S=2  (one clip, both guidance streams)   80 tiles: 1 wave, 80 of 132 SMs
//   S=4  (two clips)                        160 tiles: 2 waves (132 + 28)
//   S=16 (a training batch)                 640 tiles: 5 waves (4.85 full)
// A ragged T=100 gives one tile a sequence (28 of its 128 rows are zero-filled
// on load and not stored). One block is resident per SM (its ring takes 192
// KB), min(tiles, 132) persistent blocks walk the list in a fixed round-robin
// order, and a block's ring keeps loading its next tile while its epilogue
// runs. Measured beside it on an H100 and withdrawn: 64-frame tiles (160
// tiles at S=2, two waves whichever way they are dealt), 32- and 128-column
// pairs (lower reuse per byte from the L2, or too few tiles), a 3-stage ring
// with two blocks an SM, a grid capped below the resident blocks.

#include "gated_stack.cuh"

#include <dlfcn.h>
#include <math.h>

#include "gemm_sm90.cuh"

namespace drk {

// y = bf16(x + tb[b]) for layer 0 (later layers get theirs from out_kernel).
// With `step` set, the time bias is that of reverse step *step: tb + *step * tb_ss.
__global__ void __launch_bounds__(NT)
prep_kernel(const bf16* __restrict__ x, const float* __restrict__ tb, int tb_bs,
            const int* __restrict__ step, int tb_ss, bf16* __restrict__ y, int M, int T,
            int C) {
  if (step) tb += (size_t)*step * tb_ss;
  add_time_bias(x, tb, tb_bs, y, M, T, C);
}

// One output tile of a block's walk: column pair n0, sequence, first frame.
struct TileAt {
  int n0, seq, t0;
};
template <class G>
__device__ __forceinline__ TileAt tile_at(int tile, int C, int tiles_per_seq) {
  const int ncol = C / G::BN;
  const int rt = tile / ncol;
  return {(tile - rt * ncol) * G::BN, rt / tiles_per_seq, (rt % tiles_per_seq) * G::BM};
}

using sm90::Lane;
using sm90::lane_of_thread;
using sm90::store2;

// sigmoid(a1) * tanh(a2) on the special-function unit (gemm_sm90.cuh).
__device__ __forceinline__ float gate_fast(float a1, float a2) {
  return sm90::sigmoid_fast(a1) * sm90::tanh_fast(a2);
}

// The forward's B boxes: k tile kt of the column pair (n0 .. n0 + BN,
// C + n0 .. C + n0 + BN) of layer `layer`'s (K, 2C) row-major weights.
template <class G>
struct pair_box {
  const CUtensorMap* map_w;
  int n0, C, layer;
  __device__ __forceinline__ void operator()(int kt, int i, const CUtensorMap*& map, int& c0,
                                             int& c1, int& c2) const {
    map = map_w;
    c0 = (i < G::NBOX / 2 ? n0 : C + n0 - G::BN) + i * 64;
    c1 = kt * sm90::BK;
    c2 = layer;
  }
};

struct GateArgs {
  const float* colbias;  // (2C) or nullptr
  const float* rowbias;  // (M, 2C) or nullptr
  bf16* g;               // (M, C)
  bf16* a_save;          // (M, 2C) under SAVE: the pre-gate activation, for the backward
  int layer, T, C, taps, dil;
  int kcond;             // conditioner lanes that follow the taps in K, or 0
  int tiles_per_seq, ntiles;
};

// SAVE (the training forward) also stores the pre-gate activation. It is a
// template argument so that the inference kernel carries none of it.
template <class G, bool SAVE>
__global__ void __launch_bounds__(G::THREADS)
gate_kernel(const __grid_constant__ CUtensorMap map_y, const __grid_constant__ CUtensorMap map_cond,
            const __grid_constant__ CUtensorMap map_w, const GateArgs p) {
  extern __shared__ unsigned char smem_raw[];
  G gemm;
  gemm.init(smem_raw);
  const int kc = p.taps * p.C;
  const int nk = (kc + p.kcond) / sm90::BK;
  int it = 0;

  if (threadIdx.x >= G::NWG * 128) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == G::NWG * 128) {
      sm90::tma_prefetch_map(&map_y);
      sm90::tma_prefetch_map(&map_w);
      for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
        const TileAt at = tile_at<G>(tile, p.C, p.tiles_per_seq);
        gemm.produce(
            nk,
            [&](int kt, int, const CUtensorMap*& map, int& c0, int& c1, int& c2) {
              const int k0 = kt * sm90::BK;
              if (k0 < kc) {  // tap j: the frames (j - taps/2) * dil away
                const int j = k0 / p.C;
                map = &map_y;
                c0 = k0 - j * p.C;
                c1 = at.t0 + (j - p.taps / 2) * p.dil;
              } else {
                map = &map_cond;
                c0 = k0 - kc;
                c1 = at.t0;
              }
              c2 = at.seq;
            },
            pair_box<G>{&map_w, at.n0, p.C, p.layer}, it);
      }
    }
    return;
  }

  const Lane ln = lane_of_thread();
  const size_t two_c = 2 * (size_t)p.C;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const TileAt at = tile_at<G>(tile, p.C, p.tiles_per_seq);
    // The biases do not depend on the products: their loads are issued before
    // the k loop and land while it runs.
    float2 bias[2][G::BN / 8][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = at.t0 + ln.row + 8 * h;
      const size_t m = (size_t)at.seq * p.T + t;
#pragma unroll
      for (int j = 0; j < G::BN / 8; ++j) {
        const int n = at.n0 + 8 * j + ln.col;
        float2 b1 = make_float2(0.0f, 0.0f), b2 = b1;
        if (p.colbias) {
          b1 = *reinterpret_cast<const float2*>(p.colbias + n);
          b2 = *reinterpret_cast<const float2*>(p.colbias + p.C + n);
        }
        if (p.rowbias && t < p.T) {
          const float2 r1 = *reinterpret_cast<const float2*>(p.rowbias + m * two_c + n);
          const float2 r2 = *reinterpret_cast<const float2*>(p.rowbias + m * two_c + p.C + n);
          b1.x += r1.x; b1.y += r1.y; b2.x += r2.x; b2.y += r2.y;
        }
        bias[h][j][0] = b1;
        bias[h][j][1] = b2;
      }
    }
    float d[G::ACC];
    gemm.consume(d, ln.wg, nk, it);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = at.t0 + ln.row + 8 * h;
      if (t >= p.T) continue;  // a ragged last tile: rows past the sequence are not stored
      const size_t m = (size_t)at.seq * p.T + t;
#pragma unroll
      for (int j = 0; j < G::BN / 8; ++j) {
        const int n = at.n0 + 8 * j + ln.col;
        const float a1x = d[4 * j + 2 * h] + bias[h][j][0].x;
        const float a1y = d[4 * j + 2 * h + 1] + bias[h][j][0].y;
        const float a2x = d[4 * (j + G::BN / 8) + 2 * h] + bias[h][j][1].x;
        const float a2y = d[4 * (j + G::BN / 8) + 2 * h + 1] + bias[h][j][1].y;
        store2(p.g + m * p.C + n, gate_fast(a1x, a2x), gate_fast(a1y, a2y));
        if constexpr (SAVE) {
          store2(p.a_save + m * two_c + n, a1x, a1y);
          store2(p.a_save + m * two_c + p.C + n, a2x, a2y);
        }
      }
    }
  }
}

struct OutArgs {
  const float* bo;       // (2C)
  const bf16* x_in;      // this layer's input x ...
  bf16* x_out;           // ... and its output (the same buffer unless x is being saved)
  float* skip;
  bf16* y;               // the next layer's taps input, when tb_next is set
  const float* tb_next;  // the next layer's time bias, or nullptr
  const int* step;       // device: the reverse step whose time bias this is, or nullptr (0)
  int tb_ss;             // floats between two steps' time biases
  int tb_bs, layer, T, C, accumulate;
  float scale;
  int tiles_per_seq, ntiles;
};

template <class G>
__global__ void __launch_bounds__(G::THREADS)
out_kernel(const __grid_constant__ CUtensorMap map_g, const __grid_constant__ CUtensorMap map_w,
           const OutArgs p) {
  extern __shared__ unsigned char smem_raw[];
  G gemm;
  gemm.init(smem_raw);
  const int nk = p.C / sm90::BK;
  int it = 0;

  if (threadIdx.x >= G::NWG * 128) {
    if (threadIdx.x == G::NWG * 128) {
      sm90::tma_prefetch_map(&map_g);
      sm90::tma_prefetch_map(&map_w);
      for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
        const TileAt at = tile_at<G>(tile, p.C, p.tiles_per_seq);
        gemm.produce(
            nk,
            [&](int kt, int, const CUtensorMap*& map, int& c0, int& c1, int& c2) {
              map = &map_g;
              c0 = kt * sm90::BK;
              c1 = at.t0;
              c2 = at.seq;
            },
            pair_box<G>{&map_w, at.n0, p.C, p.layer}, it);
      }
    }
    return;
  }

  const Lane ln = lane_of_thread();
  const float* tb_next = p.tb_next;
  if (tb_next && p.step) tb_next += (size_t)*p.step * p.tb_ss;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const TileAt at = tile_at<G>(tile, p.C, p.tiles_per_seq);
    float d[G::ACC];
    gemm.consume(d, ln.wg, nk, it);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = at.t0 + ln.row + 8 * h;
      if (t >= p.T) continue;  // a ragged last tile: rows past the sequence are not stored
      const size_t row = ((size_t)at.seq * p.T + t) * p.C + at.n0 + ln.col;
      const float* tbn = tb_next ? tb_next + (size_t)at.seq * p.tb_bs + at.n0 + ln.col : nullptr;
      // every load of the row first: x and skip may alias what is stored below.
      // (Issuing them before the k loop was measured and is slower: a block of
      // 288 threads leaves 168 registers a thread, and the accumulators spill.)
      float2 xv[G::BN / 8], sv[G::BN / 8], tv[G::BN / 8];
#pragma unroll
      for (int j = 0; j < G::BN / 8; ++j) {
        xv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.x_in + row + 8 * j));
        sv[j] = p.accumulate ? *reinterpret_cast<const float2*>(p.skip + row + 8 * j)
                             : make_float2(0.0f, 0.0f);
        tv[j] = tbn ? *reinterpret_cast<const float2*>(tbn + 8 * j) : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int j = 0; j < G::BN / 8; ++j) {
        const int n = at.n0 + 8 * j + ln.col;
        const float2 b_r = *reinterpret_cast<const float2*>(p.bo + n);
        const float2 b_s = *reinterpret_cast<const float2*>(p.bo + p.C + n);
        const __nv_bfloat162 xq =
            __floats2bfloat162_rn((xv[j].x + d[4 * j + 2 * h] + b_r.x) * SQRT_HALF,
                                  (xv[j].y + d[4 * j + 2 * h + 1] + b_r.y) * SQRT_HALF);
        *reinterpret_cast<__nv_bfloat162*>(p.x_out + row + 8 * j) = xq;
        *reinterpret_cast<float2*>(p.skip + row + 8 * j) =
            make_float2((sv[j].x + d[4 * (j + G::BN / 8) + 2 * h] + b_s.x) * p.scale,
                        (sv[j].y + d[4 * (j + G::BN / 8) + 2 * h + 1] + b_s.y) * p.scale);
        if (tbn) {  // y for the next layer, from the bf16-rounded x
          const float2 xr = __bfloat1622float2(xq);
          store2(p.y + row + 8 * j, xr.x + tv[j].x, xr.y + tv[j].y);
        }
      }
    }
  }
}

// ---- host side

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which this library does not link:
// the entry is looked up in the libcuda the process has already loaded.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

}  // namespace

// A bf16 tensor (d2, d1, d0), d0 contiguous, cut into boxes of 1 x box_rows x
// 64 elements (one 128-byte swizzle span); what a box holds outside the
// tensor is zero-filled.
cudaError_t make_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
                     uint64_t stride1, uint64_t stride2, uint32_t box_rows) {
  EncodeTiled encode = encoder();
  if (!encode) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {stride1 * sizeof(bf16), stride2 * sizeof(bf16)};
  const cuuint32_t box[3] = {64, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

namespace {

// The tile that is built: 128 frames (two consumer warpgroups) x a pair of 64
// columns, behind a ring of 6 stages of 32 KB: one block an SM with ~190 KB
// of loads in flight.
using Tile = sm90::TileGemm<64, 2, 6>;

// Once per process: the kernels' shared-memory size, and how many blocks the card holds.
cudaError_t resident_blocks(int* out) {
  static int blocks = 0;
  if (!blocks) {
    const void* fns[] = {(const void*)gate_kernel<Tile, false>,
                         (const void*)gate_kernel<Tile, true>, (const void*)out_kernel<Tile>};
    for (const void* fn : fns) {
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM_BYTES);
      if (e != cudaSuccess) return e;
    }
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gate_kernel<Tile, false>,
                                                        Tile::THREADS, Tile::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    blocks = sms * per_sm;
  }
  *out = blocks;
  return cudaSuccess;
}

}  // namespace

cudaError_t plan_stack(const StackArgs& a, StackPlan* p) {
  const int kcond = a.cond ? a.mp : 0;
  if (a.T < 1 || a.M % a.T || a.C % Tile::BN || a.C % sm90::BK || kcond % sm90::BK)
    return cudaErrorInvalidValue;
  const uint64_t S = a.M / a.T, T = a.T, C = a.C, two_c = 2 * C;
  int resident = 0;
  cudaError_t e = resident_blocks(&resident);
  if (e != cudaSuccess) return e;
  p->a = a;
  p->tiles_per_seq = (a.T + Tile::BM - 1) / Tile::BM;
  p->ntiles = (int)S * p->tiles_per_seq * (a.C / Tile::BN);
  p->grid = p->ntiles < resident ? p->ntiles : resident;
  e = make_map(&p->map_y, a.y, C, T, S, C, T * C, Tile::BM);
  if (e == cudaSuccess) e = make_map(&p->map_g, a.g, C, T, S, C, T * C, Tile::BM);
  if (e == cudaSuccess && kcond)
    e = make_map(&p->map_cond, a.cond, a.mp, T, S, a.mp, T * a.mp, Tile::BM);
  if (e == cudaSuccess)
    e = make_map(&p->map_wcat, a.wcat, two_c, a.w_rows, a.L, two_c, a.w_rows * two_c, sm90::BK);
  if (e == cudaSuccess)
    e = make_map(&p->map_wo, a.wo, two_c, C, a.L, two_c, C * two_c, sm90::BK);
  return e;
}

cudaError_t run_stack(const StackPlan& p, const float* tb, const int* step, int tb_ss,
                      cudaStream_t stream) {
  const StackArgs& a = p.a;
  const size_t two_c = 2 * (size_t)a.C;
  const size_t mc = (size_t)a.M * a.C;
  const int prep_blocks = (int)((mc / 8 + NT - 1) / NT);
  prep_kernel<<<prep_blocks, NT, 0, stream>>>(a.xs ? a.xs : a.x, tb, a.tb_bs, step, tb_ss, a.y,
                                              a.M, a.T, a.C);
  for (int l = 0; l < a.L; ++l) {
    GateArgs ga;
    ga.colbias = a.colbias ? a.colbias + l * two_c : nullptr;
    ga.rowbias = a.rowbias ? a.rowbias + (size_t)l * a.M * two_c : nullptr;
    ga.g = a.g;
    ga.a_save = a.a_save ? a.a_save + (size_t)l * 2 * mc : nullptr;
    ga.layer = l;
    ga.T = a.T;
    ga.C = a.C;
    ga.taps = a.taps;
    ga.dil = a.dil[l];
    ga.kcond = a.cond ? a.mp : 0;
    ga.tiles_per_seq = p.tiles_per_seq;
    ga.ntiles = p.ntiles;
    const CUtensorMap& map_cond = a.cond ? p.map_cond : p.map_y;  // unread without lanes
    if (a.parts & 1) {
      if (a.a_save)
        gate_kernel<Tile, true><<<p.grid, Tile::THREADS, Tile::SMEM_BYTES, stream>>>(
            p.map_y, map_cond, p.map_wcat, ga);
      else
        gate_kernel<Tile, false><<<p.grid, Tile::THREADS, Tile::SMEM_BYTES, stream>>>(
            p.map_y, map_cond, p.map_wcat, ga);
    }

    OutArgs oa;
    oa.bo = a.bo + l * two_c;
    oa.x_in = a.xs ? a.xs + (size_t)l * mc : a.x;
    oa.x_out = a.xs && l + 1 < a.L ? a.xs + (size_t)(l + 1) * mc : a.x;
    oa.skip = a.skip;
    oa.y = a.y;
    oa.tb_next = l + 1 < a.L ? tb + (size_t)(l + 1) * a.tb_ls : nullptr;
    oa.step = step;
    oa.tb_ss = tb_ss;
    oa.tb_bs = a.tb_bs;
    oa.layer = l;
    oa.T = a.T;
    oa.C = a.C;
    oa.accumulate = l > 0;
    oa.scale = l == a.L - 1 ? 1.0f / sqrtf((float)a.L) : 1.0f;
    oa.tiles_per_seq = p.tiles_per_seq;
    oa.ntiles = p.ntiles;
    if (a.parts & 2)
      out_kernel<Tile><<<p.grid, Tile::THREADS, Tile::SMEM_BYTES, stream>>>(p.map_g, p.map_wo,
                                                                            oa);
  }
  return cudaGetLastError();
}

cudaError_t launch_stack(const StackArgs& a, cudaStream_t stream) {
  StackPlan plan;
  const cudaError_t e = plan_stack(a, &plan);
  return e != cudaSuccess ? e : run_stack(plan, a.tb, nullptr, 0, stream);
}

}  // namespace drk

extern "C" {

const char* drk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// K1 entry: one pass of the stack. Pointers are device pointers except
// `dil` (a host int[L]); see drk::StackArgs for shapes. `parts` is 3; 1 and 2
// launch the gate or the output GEMMs alone (for timing: the result is void).
int drk_gated_stack(void* x, void* skip, void* g, void* y, const void* tb, int tb_ls, int tb_bs,
                    const void* cond, int mp, const void* wcat, int w_rows,
                    const void* colbias, const void* rowbias, const void* wo,
                    const void* bo, const void* dil, int L, int M, int T, int C, int taps,
                    int parts, void* stream) {
  drk::StackArgs a;
  a.x = static_cast<drk::bf16*>(x);
  a.skip = static_cast<float*>(skip);
  a.g = static_cast<drk::bf16*>(g);
  a.y = static_cast<drk::bf16*>(y);
  a.tb = static_cast<const float*>(tb);
  a.tb_ls = tb_ls;
  a.tb_bs = tb_bs;
  a.cond = static_cast<const drk::bf16*>(cond);
  a.mp = mp;
  a.wcat = static_cast<const drk::bf16*>(wcat);
  a.w_rows = w_rows;
  a.colbias = static_cast<const float*>(colbias);
  a.rowbias = static_cast<const float*>(rowbias);
  a.wo = static_cast<const drk::bf16*>(wo);
  a.bo = static_cast<const float*>(bo);
  a.dil = static_cast<const int*>(dil);
  a.L = L;
  a.M = M;
  a.T = T;
  a.C = C;
  a.taps = taps;
  a.parts = parts;
  return (int)drk::launch_stack(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
