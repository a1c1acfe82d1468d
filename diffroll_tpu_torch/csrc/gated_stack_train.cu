// Training kernels of the gated dilated-conv stack, hand-written for Hopper
// (sm_90a): the forward that also saves what the backward needs, and the
// backward, one reverse sweep over the layers.
//
// Replaces diffroll_tpu/ops/gated_stack_train.py::gated_stack_fwd_pallas and
// ::gated_stack_bwd_pallas (the Pallas TPU kernels; bodies `_kernel` with
// xs_ref/a_ref set, and `_bwd_kernel`).
//
// Forward with saves (drk_gated_stack_fwd_saves): K1's kernels
// (gated_stack.cu) with two pointers set. The gate GEMM's epilogue stores the
// pre-gate activation a (M, 2C) rounded to bf16 beside g; the output GEMM
// reads layer l's x from xs[l] and writes its result to xs[l + 1], so the
// chain of layer inputs IS the save and costs no extra store.
//
// Backward (drk_gated_stack_bwd), per layer l = L-1 .. 0, rows m = b*T + t:
//   dout = [dx / sqrt(2), cot / sqrt(L)]               rounded to bf16 (dout16)
//   g    = sigmoid(a1) * tanh(a2), y = xs + tb         recomputed from the saves, bf16
//   dWo  = g^T dout16                                  (C, 2C)
//   dg   = dout16 Wo^T
//   da   = [dg th s1 (1 - s1), dg s1 (1 - th^2)]       f32; rounded to bf16 (da16)
//   db   = column sums of da (f32)
//   dW   = [shift_0(y) | .. | shift_k-1(y) | cond]^T da16   (k*C + mp, 2C): dWd taps, dWc
//   dcond += da16 Wc^T                                 only where asked
//   dx   = dx / sqrt(2) + sum_j shift_{-off_j}(da16 Wd_j^T)
//   S_l  = per-sequence column sums of dx              (the wrapper forms dtb and
//                                                       dbo from S_l and S_{l+1})
//
// Bound on this card: operations. At B=16 (M = 10,240 rows) one layer of the
// backward is ~91 GFLOP in bf16 against ~0.2 GB of operands, so every product
// runs on the TMA + wgmma core of gemm_sm90.cuh: 128 x 128 output tiles, f32
// sums in registers, finished by the epilogue from those registers, persistent
// blocks behind a 6-stage ring. Launches per layer:
//   y_kernel      y = bf16(xs + tb), elementwise.
//   nt_kernel<DgEpi>  dg: A = dout16 through a (2C, T, B) tensor map, B = Wo^T
//                 read K-major out of the forward's own (C, 2C) wo: no
//                 transposed copy. The epilogue applies the gate's derivative
//                 and writes da16, g (for dWo) and per-warp column sums of da.
//   wgrad_kernel  twice: dWo = g^T dout16 and dW = [shifted y | cond]^T da16,
//                 the products that contract over rows. Both operands are
//                 MN-major boxes (64 channels or columns x 64 frames of one
//                 sequence; both wgmma transpose flags set); a tap is the y box
//                 at frame f0 + (j - k/2) d. Zero-filled frames make at least
//                 one factor of every product outside a sequence zero. The k
//                 loop walks a sequence's 64-frame boxes, then the sequences of
//                 the block's split.
//   nt_kernel<DcondEpi>  where a conditioner gradient is asked for: B = Wc^T,
//                 K-major out of wcat's conditioner rows.
//   nt_kernel<DyEpi>  dy: the gate GEMM's twin. A tap is the da16 box at frame
//                 t0 - (j - k/2) d, zero-filled outside [0, T); B is tap j's
//                 Wd_j^T, K-major out of wcat (row jC + n). The epilogue does
//                 dx = dx / sqrt(2) + dy, writes the next layer's
//                 dout16[:, :C] = bf16(dx / sqrt(2)) and per-warp column sums
//                 of dx (a tile is one sequence's frames).
// After the sweep two seqsum launches add the per-warp sums (db, S_l) in a
// fixed order.
//
// The Pallas grid is sequential, so its kernel emits the weight gradients per
// batch tile and sums them afterwards. Here blocks run in no order. A weight
// gradient's rows are split by whole sequences where that fills the card
// (ops/gated_stack_train.py::wgrad_plan: at the flagship widths dW's 112 tiles
// run unsplit, dWo's 32 tiles in 4 splits); every split writes its own f32
// partial tile and reduce_kernel adds the partials in a fixed order. No
// atomics anywhere, so every output is the same bits from run to run.

#include "gated_stack.cuh"

#include <math.h>

#include "gemm_sm90.cuh"

namespace drk {

using sm90::Lane;
using sm90::lane_of_thread;

constexpr int BT = 128;  // rows and columns of a backward tile
using TileNT = sm90::TileGemm<64, 2, 6, 0, 0>;  // dy, dg, dcond: A and B K-major
using TileTN = sm90::TileGemm<64, 2, 6, 1, 1>;  // wgrad: A and B MN-major
static_assert(TileNT::BM == BT && 2 * TileNT::BN == BT && TileTN::BM == BT, "128 x 128 tiles");

// dout16 = [0, cot / sqrt(L)]: the first layer of the sweep's; later layers
// get their first half from dy's epilogue, the skip half stays.
__global__ void __launch_bounds__(NT)
dout_init_kernel(const float* __restrict__ cot, bf16* __restrict__ dout, int M, int C,
                 float skip_scale) {
  const size_t n8 = (size_t)M * C / 8;
  for (size_t i = blockIdx.x * (size_t)NT + threadIdx.x; i < n8; i += (size_t)gridDim.x * NT) {
    const size_t e = i * 8;
    const size_t row2 = (e / C) * 2 * C + e % C;
    const float4 c0 = *reinterpret_cast<const float4*>(cot + e);
    const float4 c1 = *reinterpret_cast<const float4*>(cot + e + 4);
    const float v[8] = {c0.x * skip_scale, c0.y * skip_scale, c0.z * skip_scale, c0.w * skip_scale,
                        c1.x * skip_scale, c1.y * skip_scale, c1.z * skip_scale, c1.w * skip_scale};
    *reinterpret_cast<uint4*>(dout + row2) = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dout + row2 + C) = pack8(v);
  }
}

// y = bf16(xs + tb[b]): the taps' operand of this layer's dW.
__global__ void __launch_bounds__(NT)
y_kernel(const bf16* __restrict__ xs, const float* __restrict__ tb, int tb_bs,
         bf16* __restrict__ y, int M, int T, int C) {
  add_time_bias(xs, tb, tb_bs, y, M, T, C);
}

// Adds a value over the 8 row lanes of a warp that hold the same accumulator
// columns (lanes that differ in bits 2..4), in a fixed order.
__device__ __forceinline__ float sum_row_lanes(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One tile of an epilogue: the 128 frames from t0 of sequence `seq`, the 128
// output columns from n0; `rt` counts the row tiles over all sequences.
struct BwdTile {
  int n0, seq, t0, rt;
};

// The epilogues read what they need in groups of EPI_J 8-column chunks, every
// load of a group started before its first use: read one chunk at a time, each
// load waits behind the stores of the chunk before it (they may alias, for all
// the compiler knows) and a tile's epilogue costs 16 trips to device memory.
// bf16 rows move 16 bytes a lane: a quad of lanes trades its four chunks'
// column pairs for whole chunks (sm90::quad_transpose); with 4-byte stores of a
// lane's own pairs dg took twice as long (H100, M = 10,240: 70.9 against 35.9
// us a call).
constexpr int EPI_J = 8;
constexpr int EPI_Q = EPI_J / 4;  // groups of four chunks, one chunk a lane of the quad

__device__ __forceinline__ void load_chunk(unsigned int (&v)[4], const bf16* src, bool ok) {
  const uint4 u = ok ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0u, 0u, 0u, 0u);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void store_chunk(bf16* dst, const unsigned int (&v)[4], bool ok) {
  if (ok) *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// dg's epilogue: the gate's derivative from the accumulators.
struct DgEpi {
  const bf16* a;   // (M, 2C) this layer's save
  bf16* da;        // (M, 2C)
  bf16* g;         // (M, C)
  float* db_part;  // (row tiles * 8, 2C): column sums of the f32 da per warp
  int T, C;
  __device__ __forceinline__ void operator()(const float (&d)[TileNT::ACC], const Lane& ln,
                                             const BwdTile& at) const {
    const int warp = threadIdx.x / 32, q = threadIdx.x & 3;
    float* dbp = db_part + ((size_t)at.rt * 8 + warp) * 2 * C + at.n0 + ln.col;
    // a ragged last tile: rows past the sequence are neither read nor stored
    const bool ok[2] = {at.t0 + ln.row < T, at.t0 + ln.row + 8 < T};
    const size_t m0 = (size_t)at.seq * T + at.t0 + ln.row;
#pragma unroll
    for (int jg = 0; jg < BT / 8; jg += EPI_J) {
      unsigned int r1[EPI_Q][2][4], r2[EPI_Q][2][4];  // the save's halves, packed bf16 pairs
#pragma unroll
      for (int qg = 0; qg < EPI_Q; ++qg)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // lane q reads chunk jg + 4 qg + q whole
          const bf16* src = a + (m0 + 8 * h) * 2 * C + at.n0 + 8 * (jg + 4 * qg + q);
          load_chunk(r1[qg][h], src, ok[h]);
          load_chunk(r2[qg][h], src + C, ok[h]);
        }
#pragma unroll
      for (int qg = 0; qg < EPI_Q; ++qg) {
        unsigned int o1[2][4], o2[2][4], og[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // ... and gets its own column pair of four chunks
          sm90::quad_transpose(r1[qg][h]);
          sm90::quad_transpose(r2[qg][h]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = jg + 4 * qg + c;
          float s1x = 0.0f, s1y = 0.0f, s2x = 0.0f, s2y = 0.0f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 a1 = sm90::unpack_bf16x2(r1[qg][h][c]);
            const float2 a2 = sm90::unpack_bf16x2(r2[qg][h][c]);
            const float sx = sm90::sigmoid_fast(a1.x), sy = sm90::sigmoid_fast(a1.y);
            const float tx = sm90::tanh_fast(a2.x), ty = sm90::tanh_fast(a2.y);
            const float gx = d[4 * j + 2 * h], gy = d[4 * j + 2 * h + 1];
            const float d1x = gx * tx * sx * (1.0f - sx), d1y = gy * ty * sy * (1.0f - sy);
            const float d2x = gx * sx * (1.0f - tx * tx), d2y = gy * sy * (1.0f - ty * ty);
            o1[h][c] = sm90::pack_bf16x2(d1x, d1y);
            o2[h][c] = sm90::pack_bf16x2(d2x, d2y);
            og[h][c] = sm90::pack_bf16x2(sx * tx, sy * ty);
            if (ok[h]) {
              s1x += d1x; s1y += d1y; s2x += d2x; s2y += d2y;
            }
          }
          s1x = sum_row_lanes(s1x); s1y = sum_row_lanes(s1y);
          s2x = sum_row_lanes(s2x); s2y = sum_row_lanes(s2y);
          if (threadIdx.x % 32 < 4) {
            *reinterpret_cast<float2*>(dbp + 8 * j) = make_float2(s1x, s1y);
            *reinterpret_cast<float2*>(dbp + C + 8 * j) = make_float2(s2x, s2y);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // back to whole chunks: lane q writes chunk jg + 4 qg + q
          sm90::quad_transpose(o1[h]);
          sm90::quad_transpose(o2[h]);
          sm90::quad_transpose(og[h]);
          const size_t m = m0 + 8 * h;
          const size_t n = at.n0 + 8 * (jg + 4 * qg + q);
          store_chunk(da + m * 2 * C + n, o1[h], ok[h]);
          store_chunk(da + m * 2 * C + C + n, o2[h], ok[h]);
          store_chunk(g + m * C + n, og[h], ok[h]);
        }
      }
    }
  }
};

// dy's epilogue: the carry's update, the next layer's dout16 and S_l's parts.
struct DyEpi {
  float* dx;       // (M, C), updated in place
  bf16* dout;      // (M, 2C): its first half is written for the next layer
  float* ss_part;  // (row tiles * 8, C): column sums of the new dx per warp
  int T, C;
  __device__ __forceinline__ void operator()(const float (&d)[TileNT::ACC], const Lane& ln,
                                             const BwdTile& at) const {
    const int warp = threadIdx.x / 32, q = threadIdx.x & 3;
    float* ssp = ss_part + ((size_t)at.rt * 8 + warp) * C + at.n0 + ln.col;
    const bool ok[2] = {at.t0 + ln.row < T, at.t0 + ln.row + 8 < T};
    const size_t m0 = (size_t)at.seq * T + at.t0 + ln.row;
    const size_t col = at.n0 + ln.col;
#pragma unroll
    for (int jg = 0; jg < BT / 8; jg += EPI_J) {
      float2 x[EPI_J][2];
#pragma unroll
      for (int jj = 0; jj < EPI_J; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          x[jj][h] = ok[h] ? *reinterpret_cast<const float2*>(dx + (m0 + 8 * h) * C + col +
                                                              8 * (jg + jj))
                           : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int qg = 0; qg < EPI_Q; ++qg) {
        unsigned int o[2][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jj = 4 * qg + c, j = jg + jj;
          float sx = 0.0f, sy = 0.0f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v = make_float2(x[jj][h].x * SQRT_HALF + d[4 * j + 2 * h],
                                         x[jj][h].y * SQRT_HALF + d[4 * j + 2 * h + 1]);
            o[h][c] = sm90::pack_bf16x2(v.x * SQRT_HALF, v.y * SQRT_HALF);
            if (ok[h]) {
              *reinterpret_cast<float2*>(dx + (m0 + 8 * h) * C + col + 8 * j) = v;
              sx += v.x;
              sy += v.y;
            }
          }
          sx = sum_row_lanes(sx);
          sy = sum_row_lanes(sy);
          if (threadIdx.x % 32 < 4) *reinterpret_cast<float2*>(ssp + 8 * j) = make_float2(sx, sy);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sm90::quad_transpose(o[h]);
          store_chunk(dout + (m0 + 8 * h) * 2 * C + at.n0 + 8 * (jg + 4 * qg + q), o[h], ok[h]);
        }
      }
    }
  }
};

// dcond += da16 Wc^T, (M, mp) f32, zero before the sweep's first layer.
struct DcondEpi {
  float* dcond;
  int T, mp;
  __device__ __forceinline__ void operator()(const float (&d)[TileNT::ACC], const Lane& ln,
                                             const BwdTile& at) const {
    const bool ok[2] = {at.t0 + ln.row < T, at.t0 + ln.row + 8 < T};
    float* row = dcond + ((size_t)at.seq * T + at.t0 + ln.row) * mp + at.n0 + ln.col;
#pragma unroll
    for (int jg = 0; jg < BT / 8; jg += EPI_J) {
      float2 o[EPI_J][2];
#pragma unroll
      for (int jj = 0; jj < EPI_J; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          o[jj][h] = ok[h] ? *reinterpret_cast<const float2*>(row + (size_t)8 * h * mp +
                                                              8 * (jg + jj))
                           : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int jj = 0; jj < EPI_J; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = jg + jj;
          if (ok[h])
            *reinterpret_cast<float2*>(row + (size_t)8 * h * mp + 8 * j) =
                make_float2(o[jj][h].x + d[4 * j + 2 * h], o[jj][h].y + d[4 * j + 2 * h + 1]);
        }
    }
  }
};

// out (rows, ncols) = sum over taps j of shift_{-(j - taps/2) dil}(A) @ W_j^T,
// finished by `epi`. A is a (2C, T, sequences) tensor of bf16 rows; W_j^T is
// read K-major: output column n is weight row brow0 + j * brow_tap + n, whose
// 2C values are contiguous.
struct NtArgs {
  int layer, T, ncols, taps, dil;
  int brow0, brow_tap;
  int kt_per_tap;  // 2C / 64
  int tiles_per_seq, ntiles;
};

template <class Epi>
__global__ void __launch_bounds__(TileNT::THREADS)
nt_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
          const NtArgs p, const Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  TileNT gemm;
  gemm.init(smem_raw);
  const int nk = p.taps * p.kt_per_tap;
  const int ncol = p.ncols / BT;
  int it = 0;
  auto tile_at = [&](int tile) {
    const int rt = tile / ncol;
    return BwdTile{(tile - rt * ncol) * BT, rt / p.tiles_per_seq, (rt % p.tiles_per_seq) * BT, rt};
  };

  if (threadIdx.x >= TileNT::NWG * 128) {  // the producer warp: one thread starts every copy
    if (threadIdx.x == TileNT::NWG * 128) {
      sm90::tma_prefetch_map(&map_a);
      sm90::tma_prefetch_map(&map_w);
      for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
        const BwdTile at = tile_at(tile);
        gemm.produce(
            nk,
            [&](int kt, int, const CUtensorMap*& map, int& c0, int& c1, int& c2) {
              const int j = kt / p.kt_per_tap;
              map = &map_a;
              c0 = (kt - j * p.kt_per_tap) * sm90::BK;
              c1 = at.t0 - (j - p.taps / 2) * p.dil;  // the forward's shift, negated
              c2 = at.seq;
            },
            [&](int kt, int i, const CUtensorMap*& map, int& c0, int& c1, int& c2) {
              const int j = kt / p.kt_per_tap;
              map = &map_w;
              c0 = (kt - j * p.kt_per_tap) * sm90::BK;
              c1 = p.brow0 + j * p.brow_tap + at.n0 + i * 64;
              c2 = p.layer;
            },
            it);
      }
    }
    return;
  }

  const Lane ln = lane_of_thread();
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    float d[TileNT::ACC];
    gemm.consume(d, ln.wg, nk, it);
    epi(d, ln, tile_at(tile));
  }
}

// out[z] (P, Q) = A[sequences of split z]^T @ B[sequences of split z]: A's
// columns are kc / C shifted copies of y (M, C) and then the conditioner
// lanes; B is (M, Q). A work item is one 128 x 128 output tile of one split;
// its k loop walks the 64-frame boxes of the split's sequences. A tile's 128
// columns of A lie within one tap (C % 128 == 0).
struct WgArgs {
  float* out;  // (P, Q) when unsplit, else the partials (splits, P, Q)
  int C, kc, ctr, dil, P, Q, S;
  int seqs_per_split, kt_per_seq, ntiles, nitems;
};

__global__ void __launch_bounds__(TileTN::THREADS)
wgrad_kernel(const __grid_constant__ CUtensorMap map_y, const __grid_constant__ CUtensorMap map_cond,
             const __grid_constant__ CUtensorMap map_b, const WgArgs p) {
  extern __shared__ unsigned char smem_raw[];
  TileTN gemm;
  gemm.init(smem_raw);
  const int nq = p.Q / BT;
  int it = 0;

  if (threadIdx.x >= TileTN::NWG * 128) {
    if (threadIdx.x == TileTN::NWG * 128) {
      sm90::tma_prefetch_map(&map_y);
      sm90::tma_prefetch_map(&map_b);
      for (int item = blockIdx.x; item < p.nitems; item += gridDim.x) {
        const int z = item / p.ntiles, tile = item - z * p.ntiles;
        const int p0 = (tile / nq) * BT, q0 = (tile % nq) * BT;
        const int s0 = z * p.seqs_per_split;
        const int nk = min(p.seqs_per_split, p.S - s0) * p.kt_per_seq;
        const CUtensorMap* map_a = &map_cond;
        int ca = p0 - p.kc, off = 0;
        if (p0 < p.kc) {  // tap j of y: the frames (j - taps/2) * dil away
          const int j = p0 / p.C;
          map_a = &map_y;
          ca = p0 - j * p.C;
          off = (j - p.ctr) * p.dil;
        }
        gemm.produce(
            nk,
            [&](int kt, int i, const CUtensorMap*& map, int& c0, int& c1, int& c2) {
              const int sq = kt / p.kt_per_seq;
              map = map_a;
              c0 = ca + i * 64;
              c1 = (kt - sq * p.kt_per_seq) * sm90::BK + off;
              c2 = s0 + sq;
            },
            [&](int kt, int i, const CUtensorMap*& map, int& c0, int& c1, int& c2) {
              const int sq = kt / p.kt_per_seq;
              map = &map_b;
              c0 = q0 + i * 64;
              c1 = (kt - sq * p.kt_per_seq) * sm90::BK;
              c2 = s0 + sq;
            },
            it);
      }
    }
    return;
  }

  const Lane ln = lane_of_thread();
  for (int item = blockIdx.x; item < p.nitems; item += gridDim.x) {
    const int z = item / p.ntiles, tile = item - z * p.ntiles;
    const int p0 = (tile / nq) * BT, q0 = (tile % nq) * BT;
    const int nk = min(p.seqs_per_split, p.S - z * p.seqs_per_split) * p.kt_per_seq;
    float d[TileTN::ACC];
    gemm.consume(d, ln.wg, nk, it);
    float* out = p.out + ((size_t)z * p.P + p0 + ln.row) * p.Q + q0 + ln.col;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
        *reinterpret_cast<float2*>(out + (size_t)8 * h * p.Q + 8 * j) =
            make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
}

// dst[i] = sum over s of src[s * n + i], in the order s = 0, 1, ...
__global__ void __launch_bounds__(NT)
reduce_kernel(const float* __restrict__ src, float* __restrict__ dst, int splits, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)NT + threadIdx.x; i < n4; i += (size_t)gridDim.x * NT) {
    float4 t = reinterpret_cast<const float4*>(src)[i];
    for (int s = 1; s < splits; ++s) {
      const float4 u = reinterpret_cast<const float4*>(src)[(size_t)s * n4 + i];
      t.x += u.x; t.y += u.y; t.z += u.z; t.w += u.w;
    }
    reinterpret_cast<float4*>(dst)[i] = t;
  }
}

// dst[b, c] = sum over t of src[b, t, c]; grid (C / 64, B), 4 row lanes.
__global__ void __launch_bounds__(NT)
seqsum_kernel(const float* __restrict__ src, float* __restrict__ dst, int T, int C) {
  __shared__ float red[NT];
  const int col = blockIdx.x * 64 + (threadIdx.x & 63);
  const int lane = threadIdx.x >> 6;
  const float* base = src + (size_t)blockIdx.y * T * C + col;
  float t = 0.0f;
  for (int r = lane; r < T; r += NT / 64) t += base[(size_t)r * C];
  red[threadIdx.x] = t;
  __syncthreads();
  if (lane == 0)
    dst[(size_t)blockIdx.y * C + col] =
        red[threadIdx.x] + red[threadIdx.x + 64] + red[threadIdx.x + 128] + red[threadIdx.x + 192];
}

struct BwdArgs {
  const bf16* xs;     // (L, M, C) saves
  const bf16* a;      // (L, M, 2C) saves
  const bf16* cond;   // (M, mp) or nullptr
  int mp;
  const float* tb;    // tb[l * tb_ls + b * tb_bs + c]
  int tb_ls, tb_bs;
  const bf16* wcat;   // (L, w_rows, 2C): the forward's operand, taps then conditioner rows
  int w_rows;
  const bf16* wo;     // (L, C, 2C): the forward's operand
  const float* cot;   // (M, C)
  float* dx;          // (M, C): zero on entry, the gradient of x on return
  float* dwo;         // (L, C, 2C)
  float* dwcat;       // (L, taps * C + mp, 2C)
  float* db;          // (L, 2C)
  float* dcond;       // (M, mp) or nullptr
  float* ssum;        // (L, B, C): S_l
  float* scot;        // (B, C): per-sequence column sums of cot
  bf16* dout;         // workspace (M, 2C)
  bf16* g;            // workspace (M, C)
  bf16* y;            // workspace (M, C)
  bf16* da;           // workspace (M, 2C)
  float* part;        // workspace: the larger of the two products' (splits, P, 2C), if split
  float* db_part;     // workspace (L, row tiles * 8, 2C)
  float* ss_part;     // workspace (L, row tiles * 8, C)
  const int* dil;     // host array, L dilations
  int L, M, T, C, taps;
  int splits_wo, splits_wcat;  // whole-sequence splits of the two weight-gradient products
  int parts;          // bit 0: dg, 1: dWo, 2: dW, 3: dy, 4: the rest (timing launches one alone)
};

static int grid_for(size_t items) {
  const size_t blocks = (items + NT - 1) / NT;
  return (int)(blocks < 4096 ? blocks : 4096);
}

namespace {

// Once per process: the kernels' shared-memory size, and how many blocks the card holds.
cudaError_t bwd_resident_blocks(int* out) {
  static int blocks = 0;
  if (!blocks) {
    static_assert(TileNT::SMEM_BYTES == TileTN::SMEM_BYTES && TileNT::THREADS == TileTN::THREADS,
                  "one occupancy for the four kernels");
    const void* fns[] = {(const void*)nt_kernel<DgEpi>, (const void*)nt_kernel<DyEpi>,
                         (const void*)nt_kernel<DcondEpi>, (const void*)wgrad_kernel};
    for (const void* fn : fns) {
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, TileNT::SMEM_BYTES);
      if (e != cudaSuccess) return e;
    }
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wgrad_kernel, TileTN::THREADS,
                                                        TileTN::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    blocks = sms * per_sm;
  }
  *out = blocks;
  return cudaSuccess;
}

}  // namespace

cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const int mp = a.cond ? a.mp : 0;
  if (a.T < 1 || a.M % a.T || a.C % BT || mp % BT || a.splits_wo < 1 || a.splits_wcat < 1)
    return cudaErrorInvalidValue;
  int resident = 0;
  cudaError_t e = bwd_resident_blocks(&resident);
  if (e != cudaSuccess) return e;
  const uint64_t S = a.M / a.T, T = a.T, C = a.C, two_c = 2 * C;
  const int kc = a.taps * a.C;
  const size_t mc = (size_t)a.M * a.C;
  const int tiles_per_seq = (a.T + BT - 1) / BT;
  const int kt_per_seq = (a.T + sm90::BK - 1) / sm90::BK;
  const int rows8 = (int)S * tiles_per_seq * 8;  // per-warp sums: 8 consumer warps a row tile
  if ((uint64_t)a.splits_wo > S || (uint64_t)a.splits_wcat > S) return cudaErrorInvalidValue;

  // Boxes of 128 frames feed the row-tile GEMMs, boxes of 64 frames the weight gradients.
  CUtensorMap m_dout128, m_da128, m_wo, m_wcat, m_g64, m_dout64, m_y64, m_cond64, m_da64;
  e = make_map(&m_dout128, a.dout, two_c, T, S, two_c, T * two_c, BT);
  if (e == cudaSuccess) e = make_map(&m_da128, a.da, two_c, T, S, two_c, T * two_c, BT);
  if (e == cudaSuccess) e = make_map(&m_wo, a.wo, two_c, C, a.L, two_c, C * two_c, 64);
  if (e == cudaSuccess)
    e = make_map(&m_wcat, a.wcat, two_c, a.w_rows, a.L, two_c, a.w_rows * two_c, 64);
  if (e == cudaSuccess) e = make_map(&m_g64, a.g, C, T, S, C, T * C, sm90::BK);
  if (e == cudaSuccess) e = make_map(&m_dout64, a.dout, two_c, T, S, two_c, T * two_c, sm90::BK);
  if (e == cudaSuccess) e = make_map(&m_y64, a.y, C, T, S, C, T * C, sm90::BK);
  if (e == cudaSuccess) e = make_map(&m_da64, a.da, two_c, T, S, two_c, T * two_c, sm90::BK);
  if (e == cudaSuccess && mp)
    e = make_map(&m_cond64, a.cond, mp, T, S, mp, T * (uint64_t)mp, sm90::BK);
  if (e != cudaSuccess) return e;

  const bool rest = a.parts & 16;
  const dim3 seq_grid(a.C / 64, (unsigned)S);
  if (rest) {
    seqsum_kernel<<<seq_grid, NT, 0, stream>>>(a.cot, a.scot, a.T, a.C);
    dout_init_kernel<<<grid_for(mc / 8), NT, 0, stream>>>(a.cot, a.dout, a.M, a.C,
                                                          1.0f / sqrtf((float)a.L));
  }

  NtArgs na;
  na.T = a.T;
  na.kt_per_tap = (int)two_c / sm90::BK;
  na.tiles_per_seq = tiles_per_seq;
  auto nt_grid = [&](int ncols) {
    na.ncols = ncols;
    na.ntiles = (int)S * tiles_per_seq * (ncols / BT);
    return na.ntiles < resident ? na.ntiles : resident;
  };
  // One weight-gradient product: wgrad_kernel, then the partials' sum if it was split.
  auto wgrad = [&](const CUtensorMap& map_a, const CUtensorMap& map_c, const CUtensorMap& map_b,
                   int rows_y, int rows, int ctr, int dil, int splits, float* dst) {
    WgArgs w;
    w.out = splits > 1 ? a.part : dst;
    w.C = a.C;
    w.kc = rows_y;
    w.ctr = ctr;
    w.dil = dil;
    w.P = rows;
    w.Q = (int)two_c;
    w.S = (int)S;
    w.seqs_per_split = ((int)S + splits - 1) / splits;
    w.kt_per_seq = kt_per_seq;
    w.ntiles = (rows / BT) * ((int)two_c / BT);
    w.nitems = w.ntiles * splits;
    const int grid = w.nitems < resident ? w.nitems : resident;
    wgrad_kernel<<<grid, TileTN::THREADS, TileTN::SMEM_BYTES, stream>>>(map_a, map_c, map_b, w);
    if (splits > 1) {
      const size_t n4 = (size_t)rows * two_c / 4;
      reduce_kernel<<<grid_for(n4), NT, 0, stream>>>(a.part, dst, splits, n4);
    }
  };

  for (int l = a.L - 1; l >= 0; --l) {
    const bf16* a_l = a.a + (size_t)l * 2 * mc;
    if (rest)
      y_kernel<<<grid_for(mc / 8), NT, 0, stream>>>(a.xs + (size_t)l * mc,
                                                    a.tb + (size_t)l * a.tb_ls, a.tb_bs, a.y,
                                                    a.M, a.T, a.C);
    na.layer = l;
    if (a.parts & 1) {  // dg, da16, g, db's parts
      na.taps = 1;
      na.dil = 0;
      na.brow0 = 0;
      na.brow_tap = 0;
      const int grid = nt_grid(a.C);
      const DgEpi epi{a_l, a.da, a.g, a.db_part + (size_t)l * rows8 * two_c, a.T, a.C};
      nt_kernel<DgEpi><<<grid, TileNT::THREADS, TileNT::SMEM_BYTES, stream>>>(m_dout128, m_wo, na,
                                                                             epi);
    }
    if (a.parts & 2)  // dWo = g^T dout16: one "tap" with no shift, no conditioner lanes
      wgrad(m_g64, m_g64, m_dout64, a.C, a.C, 0, 0, a.splits_wo,
            a.dwo + (size_t)l * a.C * two_c);
    if (a.parts & 4)  // dWd taps and dWc = [shifted y | cond]^T da16
      wgrad(m_y64, mp ? m_cond64 : m_y64, m_da64, kc, kc + mp, a.taps / 2, a.dil[l],
            a.splits_wcat, a.dwcat + (size_t)l * (kc + mp) * two_c);
    if (a.dcond && rest) {
      na.taps = 1;
      na.dil = 0;
      na.brow0 = kc;
      na.brow_tap = 0;
      const int grid = nt_grid(mp);
      const DcondEpi epi{a.dcond, a.T, mp};
      nt_kernel<DcondEpi><<<grid, TileNT::THREADS, TileNT::SMEM_BYTES, stream>>>(m_da128, m_wcat,
                                                                                na, epi);
    }
    if (a.parts & 8) {  // dy, the carry, the next layer's dout16, S_l's parts
      na.taps = a.taps;
      na.dil = a.dil[l];
      na.brow0 = 0;
      na.brow_tap = a.C;
      const int grid = nt_grid(a.C);
      const DyEpi epi{a.dx, a.dout, a.ss_part + (size_t)l * rows8 * C, a.T, a.C};
      nt_kernel<DyEpi><<<grid, TileNT::THREADS, TileNT::SMEM_BYTES, stream>>>(m_da128, m_wcat, na,
                                                                             epi);
    }
  }
  if (rest) {
    // db[l] and S_l[b]: the per-warp sums, added in a fixed order
    seqsum_kernel<<<dim3((unsigned)two_c / 64, a.L), NT, 0, stream>>>(a.db_part, a.db, rows8,
                                                                       (int)two_c);
    seqsum_kernel<<<dim3(a.C / 64, (unsigned)(a.L * S)), NT, 0, stream>>>(
        a.ss_part, a.ssum, tiles_per_seq * 8, a.C);
  }
  return cudaGetLastError();
}

}  // namespace drk

extern "C" {

// K3 entry: K1's pass that also saves xs (L, M, C; xs[0] is the input, set by
// the caller) and a (L, M, 2C). `x` is an (M, C) scratch here.
int drk_gated_stack_fwd_saves(void* x, void* skip, void* g, void* y, const void* tb, int tb_ls,
                              int tb_bs, const void* cond, int mp, const void* wcat,
                              int w_rows, const void* colbias, const void* wo, const void* bo,
                              const void* dil, int L, int M, int T, int C, int taps, void* xs,
                              void* a_save, void* stream) {
  if (!xs || !a_save) return (int)cudaErrorInvalidValue;
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
  a.rowbias = nullptr;
  a.wo = static_cast<const drk::bf16*>(wo);
  a.bo = static_cast<const float*>(bo);
  a.dil = static_cast<const int*>(dil);
  a.L = L;
  a.M = M;
  a.T = T;
  a.C = C;
  a.taps = taps;
  a.xs = static_cast<drk::bf16*>(xs);
  a.a_save = static_cast<drk::bf16*>(a_save);
  return (int)drk::launch_stack(a, static_cast<cudaStream_t>(stream));
}

// K4 entry: the whole backward sweep. See drk::BwdArgs for shapes; `dil` is a
// host int[L], every other pointer a device pointer. `parts` is 31; a single
// bit launches that product alone (for timing: the result is void).
int drk_gated_stack_bwd(const void* xs, const void* a_save, const void* cond, int mp,
                        const void* tb, int tb_ls, int tb_bs, const void* wcat, int w_rows,
                        const void* wo, const void* cot, void* dx, void* dwo, void* dwcat,
                        void* db, void* dcond, void* ssum, void* scot, void* dout, void* g,
                        void* y, void* da, void* part, void* db_part, void* ss_part,
                        const void* dil, int L, int M, int T, int C, int taps, int splits_wo,
                        int splits_wcat, int parts, void* stream) {
  drk::BwdArgs a;
  a.xs = static_cast<const drk::bf16*>(xs);
  a.a = static_cast<const drk::bf16*>(a_save);
  a.cond = static_cast<const drk::bf16*>(cond);
  a.mp = mp;
  a.tb = static_cast<const float*>(tb);
  a.tb_ls = tb_ls;
  a.tb_bs = tb_bs;
  a.wcat = static_cast<const drk::bf16*>(wcat);
  a.w_rows = w_rows;
  a.wo = static_cast<const drk::bf16*>(wo);
  a.cot = static_cast<const float*>(cot);
  a.dx = static_cast<float*>(dx);
  a.dwo = static_cast<float*>(dwo);
  a.dwcat = static_cast<float*>(dwcat);
  a.db = static_cast<float*>(db);
  a.dcond = static_cast<float*>(dcond);
  a.ssum = static_cast<float*>(ssum);
  a.scot = static_cast<float*>(scot);
  a.dout = static_cast<drk::bf16*>(dout);
  a.g = static_cast<drk::bf16*>(g);
  a.y = static_cast<drk::bf16*>(y);
  a.da = static_cast<drk::bf16*>(da);
  a.part = static_cast<float*>(part);
  a.db_part = static_cast<float*>(db_part);
  a.ss_part = static_cast<float*>(ss_part);
  a.dil = static_cast<const int*>(dil);
  a.L = L;
  a.M = M;
  a.T = T;
  a.C = C;
  a.taps = taps;
  a.splits_wo = splits_wo;
  a.splits_wcat = splits_wcat;
  a.parts = parts;
  if (a.dcond && !a.cond) return (int)cudaErrorInvalidValue;
  if ((splits_wo > 1 || splits_wcat > 1) && !a.part) return (int)cudaErrorInvalidValue;
  return (int)drk::launch_bwd(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
