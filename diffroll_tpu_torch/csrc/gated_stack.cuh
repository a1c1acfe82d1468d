// Code shared by the gated-stack kernel (gated_stack.cu), the whole-process
// sampler (sampler.cu) and the training kernels (gated_stack_train.cu): the
// stack's arguments and plan, small device helpers, and the simple bf16 tile
// GEMM with f32 accumulation (nvcuda::wmma 16x16x16 fragments) that the
// sampler's once-per-clip conditioner projection still runs on. The stack's
// own products, forward and backward, run on the TMA + wgmma core of
// gemm_sm90.cuh.
//
// Tile: a block of 256 threads (8 warps, each 32 x 32) computes BM=64 rows
// x 2*BN=128 columns, where the columns are TWO slices of BN=64 of the weight
// matrix (col0.. and col1..). The gated stack uses col1 = col0 + C so that
// one block holds both halves of a gate pair (sigmoid half, tanh half) or of
// an output pair (residual half, skip half) and can finish them in its
// epilogue. K advances BK=32 per stage through a STAGES-deep ring of
// cp.async copies in shared memory, so three tiles are in flight while one
// is multiplied; rows that fall outside the operand are zero-filled by the
// copy itself. The result is left in shared memory as f32.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

namespace drk {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BM = 64;           // rows per block
constexpr int BN = 64;           // columns per half
constexpr int BK = 32;           // K per pipeline stage
constexpr int STAGES = 4;        // depth of the cp.async ring
constexpr int NT = 256;          // threads per block (8 warps)
constexpr int A_LD = BK + 8;     // padded smem strides (bf16 elements)
constexpr int B_LD = 2 * BN + 8;
constexpr int C_LD = 2 * BN + 4; // f32 elements
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int AB_BYTES = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(bf16);
constexpr int C_BYTES = BM * C_LD * (int)sizeof(float);
constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;  // dynamic: > 48 KB
constexpr int A_VECS = BM * BK / 8 / NT;      // 16-byte A loads per thread per stage
constexpr int B_VECS = BK * 2 * BN / 8 / NT;  // 16-byte B loads per thread per stage
constexpr int EPI_VECS = BM * BN / 8 / NT;    // 8-column epilogue items per thread
constexpr float SQRT_HALF = 0.7071067811865476f;

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return r;
}

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// y[m, :] = bf16(x[m, :] + tb[(m / T) * tb_bs + :]) over the (M, C) rows: the
// whole grid's job, eight values a thread a turn.
__device__ __forceinline__ void add_time_bias(const bf16* __restrict__ x,
                                              const float* __restrict__ tb, int tb_bs,
                                              bf16* __restrict__ y, int M, int T, int C) {
  const size_t n8 = (size_t)M * C / 8;
  for (size_t i = blockIdx.x * (size_t)NT + threadIdx.x; i < n8; i += (size_t)gridDim.x * NT) {
    const size_t e = i * 8;
    const int m = (int)(e / C), c = (int)(e % C);
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(x + e), v);
    const float* t = tb + (size_t)(m / T) * tb_bs + c;
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] += t[q];
    *reinterpret_cast<uint4*>(y + e) = pack8(v);
  }
}

// 16-byte global -> shared copy, zero-filling when !valid (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// The source of A[m0 + r, k0 + kv .. +8] for a plain row-major bf16 matrix.
struct RowSrc {
  const bf16* a;
  int lda, m0, M;
  __device__ __forceinline__ const bf16* operator()(int r, int k0, int kv, bool& valid) const {
    const int m = m0 + r;
    valid = m < M;
    return a + (size_t)(valid ? m : 0) * lda + k0 + kv;
  }
};

// (BM x 2BN) = A[m0:m0+BM, 0:K] @ [W[:, col0:col0+BN] | W[:, col1:col1+BN]],
// W row-major with leading dimension ldw; K % BK == 0. On return the f32
// tile is in smem as Cs[BM][C_LD] and every thread has passed a barrier.
template <class SrcA>
__device__ __forceinline__ void gemm_tile(const SrcA& src_a, const bf16* __restrict__ w,
                                          int ldw, int col0, int col1, int K,
                                          unsigned char* smem) {
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * A_STAGE;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 1;   // rows wm*32 .. +32
  const int wn = warp >> 1;  // tile columns wn*32 .. +32 (0, 1: first half; 2, 3: second)

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  auto issue = [&](int kt) {
    const int k0 = kt * BK, buf = kt % STAGES;
#pragma unroll
    for (int s = 0; s < A_VECS; ++s) {
      const int v = tid + s * NT;
      const int r = v >> 2, kv = (v & 3) * 8;
      bool valid;
      const bf16* src = src_a(r, k0, kv, valid);
      cp_async16(As + buf * A_STAGE + r * A_LD + kv, src, valid);
    }
#pragma unroll
    for (int s = 0; s < B_VECS; ++s) {
      const int v = tid + s * NT;
      const int kr = v >> 4, cv = (v & 15) * 8;
      const int col = cv < BN ? col0 + cv : col1 + cv - BN;
      cp_async16(Bs + buf * B_STAGE + kr * B_LD + cv, w + (size_t)(k0 + kr) * ldw + col, true);
    }
  };

  const int nk = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for every thread; buffer (kt-1) % STAGES is free
    if (kt + STAGES - 1 < nk) issue(kt + STAGES - 1);
    cp_async_commit();
    const bf16* a = As + (kt % STAGES) * A_STAGE;
    const bf16* b = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the f32 tile below reuses the ring's memory

  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();
}

// One pass of the L gated residual layers over M = (sequences x T) rows.
struct StackArgs {
  bf16* x;               // (M, C) hidden state, bf16, updated in place
  float* skip;           // (M, C) out: sum of skips / sqrt(L)
  bf16* g;               // (M, C) scratch: the gated activations
  bf16* y;               // (M, C) scratch: bf16(x + tb[l]), the taps' input
  const float* tb;       // time bias: tb[l * tb_ls + b * tb_bs + c]
  int tb_ls, tb_bs;
  const bf16* cond;      // (M, mp) padded conditioner in the gate GEMM, or nullptr
  int mp;
  const bf16* wcat;      // (L, w_rows, 2C): taps*C tap rows, then conditioner rows
  int w_rows;
  const float* colbias;  // (L, 2C) gate bias, or nullptr
  const float* rowbias;  // (L, M, 2C) precomputed per-row gate term, or nullptr
  const bf16* wo;        // (L, C, 2C) output projection
  const float* bo;       // (L, 2C)
  const int* dil;        // host array, L dilations
  int L, M, T, C, taps;
  int parts = 3;           // bit 0: the gate GEMMs, bit 1: the output GEMMs (timing launches one alone)
  // The training forward's saves (gated_stack_train.cu), both or neither:
  bf16* xs = nullptr;      // (L, M, C): every layer's input x, before its time bias.
                           // xs[0] holds the input on entry; layer l reads xs[l] and
                           // writes xs[l + 1] (the last layer writes `x`, a scratch).
  bf16* a_save = nullptr;  // (L, M, 2C): every layer's pre-gate activation
};

// A pass prepared once for its buffers and shape: the tile list's size, the persistent grid and the tensor maps of y, g, the
// conditioner and the two weight stacks. A caller that runs the same pass
// many times (the sampler: once per step) builds it once.
struct StackPlan {
  StackArgs a;
  CUtensorMap map_y, map_g, map_cond, map_wcat, map_wo;
  int tiles_per_seq, ntiles, grid;
};
cudaError_t plan_stack(const StackArgs& a, StackPlan* plan);
// Launches 1 + 2L kernels on `stream` with the time bias `tb` (in place of
// plan.a.tb) or, with the device counter `step` set, tb + *step * tb_ss, read
// when the kernels run: a captured pass can then be replayed for step after
// step. Returns cudaGetLastError().
cudaError_t run_stack(const StackPlan& plan, const float* tb, const int* step, int tb_ss,
                      cudaStream_t stream);

// A bf16 tensor (d2, d1, d0), d0 contiguous, cut into boxes of 1 x box_rows x
// 64 elements (one 128-byte swizzle span); what a box holds outside the
// tensor is zero-filled.
cudaError_t make_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
                     uint64_t stride1, uint64_t stride2, uint32_t box_rows);

// plan_stack + run_stack. With the saves unset this is K1 as it always was:
// the saves add stores, no arithmetic.
cudaError_t launch_stack(const StackArgs& a, cudaStream_t stream);

}  // namespace drk
