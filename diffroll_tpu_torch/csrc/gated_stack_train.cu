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
// Launches per layer: bwd_prep (elementwise), dg_kernel (GEMM + the gate's
// derivative in its epilogue), two wgrad_kernel (the products that contract
// over rows), reduce_kernel after each, dy_kernel (GEMM + the dx update),
// dcond_kernel where asked, seqsum_kernel.
//
// The Pallas grid is sequential, so its kernel emits the weight gradients per
// batch tile and sums them afterwards. Here blocks run in no order: the rows
// are split over gridDim.z, every split writes its own f32 partial tile, and
// reduce_kernel adds the partials in a fixed order. No atomics anywhere, so
// every output is the same bits from run to run.
//
// The transposed shifts stop at the clip's ends exactly as the forward's do:
// dy_kernel reads da16 through the same TapSrc with the dilation negated, and
// the copy zero-fills rows that fall outside [0, T) of the same sequence.
//
// Bound on this card: operations. At B=16 (M = 10,240 rows) one layer of the
// backward is ~91 GFLOP in bf16 against ~0.2 GB of operands and partials.
// Every product is on the tensor cores (wmma, f32 sums) and the gate's
// derivative, the dx update and the bias sums ride in GEMM epilogues. The
// tile GEMM is the simple one of gated_stack.cuh; wgmma/TMA are later work.

#include "gated_stack.cuh"

namespace drk {

constexpr int AT_LD = BM + 8;          // the TN GEMM's A tile is k-major: At[k][p]
constexpr int AT_STAGE = BK * AT_LD;
static_assert(STAGES * (AT_STAGE + B_STAGE) * (int)sizeof(bf16) <= SMEM_BYTES, "TN ring fits");
constexpr int WG_SPLITS_MAX = 16;

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Per layer, elementwise over (M, C): the bf16 operands of the layer's GEMMs.
struct PrepArgs {
  const float* dx;   // (M, C) the carry
  const float* cot;  // (M, C), read when write_skip
  const bf16* a;     // (M, 2C) this layer's save
  const bf16* xs;    // (M, C) this layer's save
  const float* tb;   // this layer's time bias: tb[b * tb_bs + c]
  int tb_bs;
  bf16* dout;        // (M, 2C)
  bf16* g;           // (M, C)
  bf16* y;           // (M, C)
  int M, T, C, write_skip;
  float skip_scale;  // 1 / sqrt(L)
};

__global__ void __launch_bounds__(NT) bwd_prep_kernel(PrepArgs p) {
  const size_t n8 = (size_t)p.M * p.C / 8;
  for (size_t i = blockIdx.x * (size_t)NT + threadIdx.x; i < n8; i += (size_t)gridDim.x * NT) {
    const size_t e = i * 8;
    const int m = (int)(e / p.C), c = (int)(e % p.C);
    const size_t row2 = (size_t)m * 2 * p.C + c;
    float v[8], w[8];
    load8(p.dx + e, v);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] *= SQRT_HALF;
    *reinterpret_cast<uint4*>(p.dout + row2) = pack8(v);
    if (p.write_skip) {  // the skip half is the same for every layer
      load8(p.cot + e, v);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] *= p.skip_scale;
      *reinterpret_cast<uint4*>(p.dout + row2 + p.C) = pack8(v);
    }
    unpack8(*reinterpret_cast<const uint4*>(p.a + row2), v);
    unpack8(*reinterpret_cast<const uint4*>(p.a + row2 + p.C), w);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = sigmoidf(v[q]) * tanhf(w[q]);
    *reinterpret_cast<uint4*>(p.g + e) = pack8(v);
    unpack8(*reinterpret_cast<const uint4*>(p.xs + e), v);
    const float* t = p.tb + (size_t)(m / p.T) * p.tb_bs + c;
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] += t[q];
    *reinterpret_cast<uint4*>(p.y + e) = pack8(v);
  }
}

// dg = dout16 @ Wo^T, then the gate's derivative: da16 and the column sums of
// the f32 da over this block's rows (db_part[blockIdx.y]).
struct DgArgs {
  const bf16* dout;  // (M, 2C)
  const bf16* woT;   // (2C, C) this layer's Wo^T
  const bf16* a;     // (M, 2C)
  bf16* da;          // (M, 2C)
  float* db_part;    // (gridDim.y, 2C)
  int M, C;
};

__global__ void __launch_bounds__(NT) dg_kernel(DgArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * 2 * BN;
  const int m0 = blockIdx.y * BM;
  const RowSrc src{p.dout, 2 * p.C, m0, p.M};
  gemm_tile(src, p.woT, p.C, n0, n0 + BN, 2 * p.C, smem);

  const float* Cs = reinterpret_cast<const float*>(smem);
  const int cv = (threadIdx.x & 15) * 8;  // this thread's 8 columns, for all its rows
  const int r0 = threadIdx.x >> 4;        // its rows: r0, r0 + 16, r0 + 32, r0 + 48
  float sum1[8], sum2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sum1[e] = sum2[e] = 0.0f;
#pragma unroll
  for (int s = 0; s < BM / 16; ++s) {
    const int r = r0 + 16 * s;
    const int m = m0 + r;
    if (m < p.M) {
      bf16* da_row = p.da + (size_t)m * 2 * p.C + n0 + cv;
      const bf16* a_row = p.a + (size_t)m * 2 * p.C + n0 + cv;
      float a1[8], a2[8];
      unpack8(*reinterpret_cast<const uint4*>(a_row), a1);
      unpack8(*reinterpret_cast<const uint4*>(a_row + p.C), a2);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dg = Cs[r * C_LD + cv + e];
        const float s1 = sigmoidf(a1[e]);
        const float th = tanhf(a2[e]);
        a1[e] = dg * th * s1 * (1.0f - s1);
        a2[e] = dg * s1 * (1.0f - th * th);
        sum1[e] += a1[e];
        sum2[e] += a2[e];
      }
      *reinterpret_cast<uint4*>(da_row) = pack8(a1);
      *reinterpret_cast<uint4*>(da_row + p.C) = pack8(a2);
    }
  }
  __syncthreads();  // every thread is done with the GEMM tile; reuse its memory
  float* red = reinterpret_cast<float*>(smem);  // [16][4 * BN]
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[r0 * 4 * BN + cv + e] = sum1[e];
    red[r0 * 4 * BN + 2 * BN + cv + e] = sum2[e];
  }
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int q = 0; q < NT / 16; ++q) t += red[q * 4 * BN + threadIdx.x];
  const int col = threadIdx.x < 2 * BN ? n0 + threadIdx.x : p.C + n0 + threadIdx.x - 2 * BN;
  p.db_part[(size_t)blockIdx.y * 2 * p.C + col] = t;
}

// out[z] (P, Q) = A[rows of split z]^T @ B[rows of split z], where A's columns
// are `kc / C` shifted copies of y (M, C) and then the mp conditioner lanes,
// and B is (M, Q) row-major. The contraction runs over the rows, so the A tile
// is copied k-major and read as a column-major wmma operand. A block owns 64
// columns of A, which lie within one tap (C % 64 == 0).
struct WgArgs {
  const bf16* y;
  const bf16* cond;  // (M, mp) or nullptr
  int mp;
  const bf16* b;     // (M, Q)
  float* part;       // (gridDim.z, P, Q)
  int M, T, C, kc, ctr, dil, P, Q, rows_per_split;
};

__global__ void __launch_bounds__(NT) wgrad_kernel(WgArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* At = reinterpret_cast<bf16*>(smem);
  bf16* Bs = At + STAGES * AT_STAGE;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 1;
  const int wn = warp >> 1;
  const int q0 = blockIdx.x * 2 * BN;
  const int p0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * p.rows_per_split;
  const int kend = min(p.M, kbeg + p.rows_per_split);

  const bf16* abase;
  int lda, off;
  if (p0 < p.kc) {
    const int j = p0 / p.C;
    abase = p.y + (p0 - j * p.C);
    lda = p.C;
    off = (j - p.ctr) * p.dil;
  } else {
    abase = p.cond + (p0 - p.kc);
    lda = p.mp;
    off = 0;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  auto issue = [&](int kt) {
    const int k0 = kbeg + kt * BK, buf = kt % STAGES;
    {
      const int kr = tid >> 3, pv = (tid & 7) * 8;
      const int m = k0 + kr;
      const int t = m % p.T + off;
      const bool valid = m < kend && t >= 0 && t < p.T;
      cp_async16(At + buf * AT_STAGE + kr * AT_LD + pv,
                 abase + (size_t)(valid ? m + off : 0) * lda + pv, valid);
    }
#pragma unroll
    for (int s = 0; s < B_VECS; ++s) {
      const int v = tid + s * NT;
      const int kr = v >> 4, cv = (v & 15) * 8;
      const int m = k0 + kr;
      const bool valid = m < kend;
      cp_async16(Bs + buf * B_STAGE + kr * B_LD + cv,
                 p.b + (size_t)(valid ? m : 0) * p.Q + q0 + cv, valid);
    }
  };

  const int nk = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) issue(kt + STAGES - 1);
    cp_async_commit();
    const bf16* a = At + (kt % STAGES) * AT_STAGE;
    const bf16* b = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + kk * AT_LD + wm * 32 + i * 16, AT_LD);
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
  __syncthreads();

  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();

  float* out = p.part + ((size_t)blockIdx.z * p.P + p0) * p.Q + q0;
#pragma unroll
  for (int s = 0; s < BM * 2 * BN / 4 / NT; ++s) {
    const int v = tid + s * NT;
    const int r = v >> 5, c4 = (v & 31) * 4;
    *reinterpret_cast<float4*>(out + (size_t)r * p.Q + c4) =
        *reinterpret_cast<const float4*>(Cs + r * C_LD + c4);
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

// dx = dx / sqrt(2) + sum_j shift_{-off_j}(da16 @ Wd_j^T): the forward's tap
// addressing over da16 (width 2C) with the dilation negated.
struct DyArgs {
  const bf16* da;   // (M, 2C)
  const bf16* wdT;  // (taps * 2C, C): tap j's rows are Wd_j^T
  float* dx;        // (M, C), updated in place
  int M, T, C, taps, dil;
};

__global__ void __launch_bounds__(NT) dy_kernel(DyArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * 2 * BN;
  const int m0 = blockIdx.y * BM;
  const int kw = p.taps * 2 * p.C;
  const TapSrc src{p.da, nullptr, 0, m0, p.M, p.T, 2 * p.C, kw, p.taps / 2, -p.dil};
  gemm_tile(src, p.wdT, p.C, n0, n0 + BN, kw, smem);

  const float* Cs = reinterpret_cast<const float*>(smem);
#pragma unroll
  for (int s = 0; s < BM * 2 * BN / 4 / NT; ++s) {
    const int v = threadIdx.x + s * NT;
    const int r = v >> 5, c4 = (v & 31) * 4;
    const int m = m0 + r;
    if (m >= p.M) continue;
    float4* d = reinterpret_cast<float4*>(p.dx + (size_t)m * p.C + n0 + c4);
    const float4 dy = *reinterpret_cast<const float4*>(Cs + r * C_LD + c4);
    float4 x = *d;
    x.x = x.x * SQRT_HALF + dy.x;
    x.y = x.y * SQRT_HALF + dy.y;
    x.z = x.z * SQRT_HALF + dy.z;
    x.w = x.w * SQRT_HALF + dy.w;
    *d = x;
  }
}

// dcond (+)= da16 @ Wc^T, (M, mp) f32.
struct DcondArgs {
  const bf16* da;   // (M, 2C)
  const bf16* wcT;  // (2C, mp)
  float* dcond;
  int M, C, mp, accumulate;
};

__global__ void __launch_bounds__(NT) dcond_kernel(DcondArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * 2 * BN;
  const int m0 = blockIdx.y * BM;
  const RowSrc src{p.da, 2 * p.C, m0, p.M};
  gemm_tile(src, p.wcT, p.mp, n0, n0 + BN, 2 * p.C, smem);

  const float* Cs = reinterpret_cast<const float*>(smem);
#pragma unroll
  for (int s = 0; s < BM * 2 * BN / 4 / NT; ++s) {
    const int v = threadIdx.x + s * NT;
    const int r = v >> 5, c4 = (v & 31) * 4;
    const int m = m0 + r;
    if (m >= p.M) continue;
    float4* d = reinterpret_cast<float4*>(p.dcond + (size_t)m * p.mp + n0 + c4);
    float4 t = *reinterpret_cast<const float4*>(Cs + r * C_LD + c4);
    if (p.accumulate) {
      const float4 o = *d;
      t.x += o.x; t.y += o.y; t.z += o.z; t.w += o.w;
    }
    *d = t;
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
  const bf16* woT;    // (L, 2C, C)
  const bf16* wdT;    // (L, taps * 2C, C)
  const bf16* wcT;    // (L, 2C, mp), read when dcond is set
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
  float* part;        // workspace (splits, taps * C + mp, 2C)
  float* db_part;     // workspace (ceil(M / 64), 2C)
  const int* dil;     // host array, L dilations
  int L, M, T, C, taps, splits;
};

static int grid_for(size_t items) {
  const size_t blocks = (items + NT - 1) / NT;
  return (int)(blocks < 4096 ? blocks : 4096);
}

cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const void* fns[] = {(const void*)dg_kernel, (const void*)wgrad_kernel,
                         (const void*)dy_kernel, (const void*)dcond_kernel};
    for (const void* fn : fns) {
      const cudaError_t e =
          cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (e != cudaSuccess) return e;
    }
    smem_set = true;
  }
  if (a.C % (2 * BN) || a.mp % (2 * BN) || a.M % a.T || a.splits < 1 ||
      a.splits > WG_SPLITS_MAX)
    return cudaErrorInvalidValue;
  const int two_c = 2 * a.C;
  const int kc = a.taps * a.C;
  const int mb = (a.M + BM - 1) / BM;
  const int bsz = a.M / a.T;
  const size_t mc = (size_t)a.M * a.C;
  int rows_per_split = (a.M + a.splits - 1) / a.splits;
  rows_per_split = (rows_per_split + BK - 1) / BK * BK;
  const dim3 seq_grid(a.C / 64, bsz);

  seqsum_kernel<<<seq_grid, NT, 0, stream>>>(a.cot, a.scot, a.T, a.C);
  for (int l = a.L - 1; l >= 0; --l) {
    PrepArgs pa;
    pa.dx = a.dx;
    pa.cot = a.cot;
    pa.a = a.a + (size_t)l * 2 * mc;
    pa.xs = a.xs + (size_t)l * mc;
    pa.tb = a.tb + (size_t)l * a.tb_ls;
    pa.tb_bs = a.tb_bs;
    pa.dout = a.dout;
    pa.g = a.g;
    pa.y = a.y;
    pa.M = a.M;
    pa.T = a.T;
    pa.C = a.C;
    pa.write_skip = l == a.L - 1;
    pa.skip_scale = 1.0f / sqrtf((float)a.L);
    bwd_prep_kernel<<<grid_for(mc / 8), NT, 0, stream>>>(pa);

    DgArgs da;
    da.dout = a.dout;
    da.woT = a.woT + (size_t)l * two_c * a.C;
    da.a = pa.a;
    da.da = a.da;
    da.db_part = a.db_part;
    da.M = a.M;
    da.C = a.C;
    dg_kernel<<<dim3(a.C / (2 * BN), mb), NT, SMEM_BYTES, stream>>>(da);
    reduce_kernel<<<grid_for(two_c / 4), NT, 0, stream>>>(a.db_part, a.db + (size_t)l * two_c,
                                                          mb, two_c / 4);

    WgArgs wo;  // dWo = g^T dout16: one "tap" with no shift, no conditioner lanes
    wo.y = a.g;
    wo.cond = nullptr;
    wo.mp = 0;
    wo.b = a.dout;
    wo.part = a.part;
    wo.M = a.M;
    wo.T = a.T;
    wo.C = a.C;
    wo.kc = a.C;
    wo.ctr = 0;
    wo.dil = 0;
    wo.P = a.C;
    wo.Q = two_c;
    wo.rows_per_split = rows_per_split;
    wgrad_kernel<<<dim3(two_c / (2 * BN), wo.P / BM, a.splits), NT, SMEM_BYTES, stream>>>(wo);
    const size_t n_wo = (size_t)wo.P * two_c / 4;
    reduce_kernel<<<grid_for(n_wo), NT, 0, stream>>>(a.part, a.dwo + (size_t)l * wo.P * two_c,
                                                     a.splits, n_wo);

    WgArgs wd = wo;  // dWd taps and dWc = [shifted y | cond]^T da16
    wd.y = a.y;
    wd.cond = a.cond;
    wd.mp = a.cond ? a.mp : 0;
    wd.b = a.da;
    wd.kc = kc;
    wd.ctr = a.taps / 2;
    wd.dil = a.dil[l];
    wd.P = kc + wd.mp;
    wgrad_kernel<<<dim3(two_c / (2 * BN), wd.P / BM, a.splits), NT, SMEM_BYTES, stream>>>(wd);
    const size_t n_wd = (size_t)wd.P * two_c / 4;
    reduce_kernel<<<grid_for(n_wd), NT, 0, stream>>>(
        a.part, a.dwcat + (size_t)l * wd.P * two_c, a.splits, n_wd);

    if (a.dcond) {
      DcondArgs dc;
      dc.da = a.da;
      dc.wcT = a.wcT + (size_t)l * two_c * a.mp;
      dc.dcond = a.dcond;
      dc.M = a.M;
      dc.C = a.C;
      dc.mp = a.mp;
      dc.accumulate = l != a.L - 1;
      dcond_kernel<<<dim3(a.mp / (2 * BN), mb), NT, SMEM_BYTES, stream>>>(dc);
    }

    DyArgs dy;
    dy.da = a.da;
    dy.wdT = a.wdT + (size_t)l * a.taps * two_c * a.C;
    dy.dx = a.dx;
    dy.M = a.M;
    dy.T = a.T;
    dy.C = a.C;
    dy.taps = a.taps;
    dy.dil = a.dil[l];
    dy_kernel<<<dim3(a.C / (2 * BN), mb), NT, SMEM_BYTES, stream>>>(dy);
    seqsum_kernel<<<seq_grid, NT, 0, stream>>>(a.dx, a.ssum + (size_t)l * bsz * a.C, a.T, a.C);
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
// host int[L], every other pointer a device pointer.
int drk_gated_stack_bwd(const void* xs, const void* a_save, const void* cond, int mp,
                        const void* tb, int tb_ls, int tb_bs, const void* woT, const void* wdT,
                        const void* wcT, const void* cot, void* dx, void* dwo, void* dwcat,
                        void* db, void* dcond, void* ssum, void* scot, void* dout, void* g,
                        void* y, void* da, void* part, void* db_part, const void* dil, int L,
                        int M, int T, int C, int taps, int splits, void* stream) {
  drk::BwdArgs a;
  a.xs = static_cast<const drk::bf16*>(xs);
  a.a = static_cast<const drk::bf16*>(a_save);
  a.cond = static_cast<const drk::bf16*>(cond);
  a.mp = mp;
  a.tb = static_cast<const float*>(tb);
  a.tb_ls = tb_ls;
  a.tb_bs = tb_bs;
  a.woT = static_cast<const drk::bf16*>(woT);
  a.wdT = static_cast<const drk::bf16*>(wdT);
  a.wcT = static_cast<const drk::bf16*>(wcT);
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
  a.dil = static_cast<const int*>(dil);
  a.L = L;
  a.M = M;
  a.T = T;
  a.C = C;
  a.taps = taps;
  a.splits = splits;
  if (a.dcond && (!a.cond || !a.wcT)) return (int)cudaErrorInvalidValue;
  return (int)drk::launch_bwd(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
