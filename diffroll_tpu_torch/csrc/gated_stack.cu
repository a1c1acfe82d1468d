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
// Form: each layer is two launches of the tile GEMM in gated_stack.cuh.
//   (a) gate_kernel: K runs over the 3 taps x C (the A tile is copied from
//       y = bf16(x + tb) with the tap's row offset, zero outside the
//       sequence) and then over the 256 zero-padded conditioner lanes; each
//       block owns the column pair (n, n + C) and writes g = sigmoid * tanh
//       as bf16.
//   (b) out_kernel: g @ Wo with the residual and skip updates in its
//       epilogue, which also writes the next layer's y; prep_kernel writes
//       layer 0's.
// The TPU kernel's roll/static-shift machinery, batch tiling and VMEM
// limit have no counterpart: a block computes its own shifted rows.
//
// Bound on this card: compute. One classifier-free-guidance step of the
// flagship (B=1 -> 2 streams x 640 frames, C=512, L=15) is ~80 GFLOP over
// ~63 MB of bf16 weights, ~1,280 FLOP per byte, well above the H100's
// ~295 FLOP/byte ridge. So the design keeps every product on the tensor
// cores in bf16 with f32 accumulation and fuses the gate, residual and skip
// updates into the GEMM epilogues (no f32 (M, 2C) pre-activation is ever
// written to device memory). wmma fragments are the simple first form;
// wgmma/TMA are later work.

#include "gated_stack.cuh"

namespace drk {

// y = bf16(x + tb[b]) for layer 0 (later layers get theirs from out_kernel).
__global__ void __launch_bounds__(NT)
prep_kernel(const bf16* __restrict__ x, const float* __restrict__ tb, int tb_bs,
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

struct GateArgs {
  const bf16* y;
  const bf16* cond;
  int mp;
  const bf16* w;         // this layer's (w_rows, 2C)
  const float* colbias;  // (2C) or nullptr
  const float* rowbias;  // (M, 2C) or nullptr
  bf16* g;
  int M, T, C, taps, dil;
};

__global__ void __launch_bounds__(NT) gate_kernel(GateArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const TapSrc src{p.y, p.cond, p.mp, m0, p.M, p.T, p.C, p.taps * p.C, p.taps / 2, p.dil};
  const int K = p.taps * p.C + (p.cond ? p.mp : 0);
  gemm_tile(src, p.w, 2 * p.C, n0, p.C + n0, K, smem);

  const float* Cs = reinterpret_cast<const float*>(smem);
#pragma unroll
  for (int s = 0; s < EPI_VECS; ++s) {
    const int v = threadIdx.x + s * NT;
    const int r = v >> 3, cv = (v & 7) * 8;
    const int m = m0 + r;
    if (m >= p.M) continue;
    const float* rb = p.rowbias ? p.rowbias + (size_t)m * 2 * p.C : nullptr;
    float out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int n = n0 + cv + e;
      float a1 = Cs[r * C_LD + cv + e];
      float a2 = Cs[r * C_LD + BN + cv + e];
      if (p.colbias) {
        a1 += p.colbias[n];
        a2 += p.colbias[p.C + n];
      }
      if (rb) {
        a1 += rb[n];
        a2 += rb[p.C + n];
      }
      out[e] = sigmoidf(a1) * tanhf(a2);
    }
    *reinterpret_cast<uint4*>(p.g + (size_t)m * p.C + n0 + cv) = pack8(out);
  }
}

struct OutArgs {
  const bf16* g;
  const bf16* w;         // this layer's (C, 2C)
  const float* bo;       // (2C)
  bf16* x;
  float* skip;
  bf16* y;               // the next layer's taps input, when tb_next is set
  const float* tb_next;  // the next layer's time bias, or nullptr
  int tb_bs, M, T, C, accumulate;
  float scale;
};

__global__ void __launch_bounds__(NT) out_kernel(OutArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const RowSrc src{p.g, p.C, m0, p.M};
  gemm_tile(src, p.w, 2 * p.C, n0, p.C + n0, p.C, smem);

  const float* Cs = reinterpret_cast<const float*>(smem);
#pragma unroll
  for (int s = 0; s < EPI_VECS; ++s) {
    const int v = threadIdx.x + s * NT;
    const int r = v >> 3, cv = (v & 7) * 8;
    const int m = m0 + r;
    if (m >= p.M) continue;
    const size_t off = (size_t)m * p.C + n0 + cv;
    float xv[8], sv[8];
    unpack8(*reinterpret_cast<const uint4*>(p.x + off), xv);
    if (p.accumulate) {
      const float4 s0 = *reinterpret_cast<const float4*>(p.skip + off);
      const float4 s1 = *reinterpret_cast<const float4*>(p.skip + off + 4);
      sv[0] = s0.x; sv[1] = s0.y; sv[2] = s0.z; sv[3] = s0.w;
      sv[4] = s1.x; sv[5] = s1.y; sv[6] = s1.z; sv[7] = s1.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) sv[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int n = n0 + cv + e;
      const float out_r = Cs[r * C_LD + cv + e] + p.bo[n];
      const float out_s = Cs[r * C_LD + BN + cv + e] + p.bo[p.C + n];
      xv[e] = (xv[e] + out_r) * SQRT_HALF;
      sv[e] = (sv[e] + out_s) * p.scale;
    }
    const uint4 xq = pack8(xv);
    *reinterpret_cast<uint4*>(p.x + off) = xq;
    *reinterpret_cast<float4*>(p.skip + off) = make_float4(sv[0], sv[1], sv[2], sv[3]);
    *reinterpret_cast<float4*>(p.skip + off + 4) = make_float4(sv[4], sv[5], sv[6], sv[7]);
    if (p.tb_next) {  // y for the next layer, from the bf16-rounded x
      unpack8(xq, xv);
      const float* t = p.tb_next + (size_t)(m / p.T) * p.tb_bs + n0 + cv;
#pragma unroll
      for (int e = 0; e < 8; ++e) xv[e] += t[e];
      *reinterpret_cast<uint4*>(p.y + off) = pack8(xv);
    }
  }
}

cudaError_t launch_stack(const StackArgs& a, cudaStream_t stream) {
  static bool smem_set = false;  // the GEMM ring needs > 48 KB of dynamic shared memory
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid(a.C / BN, (a.M + BM - 1) / BM);
  const size_t two_c = 2 * (size_t)a.C;
  const int prep_blocks = (int)(((size_t)a.M * a.C / 8 + NT - 1) / NT);
  prep_kernel<<<prep_blocks, NT, 0, stream>>>(a.x, a.tb, a.tb_bs, a.y, a.M, a.T, a.C);
  for (int l = 0; l < a.L; ++l) {
    GateArgs ga;
    ga.y = a.y;
    ga.cond = a.cond;
    ga.mp = a.mp;
    ga.w = a.wcat + (size_t)l * a.w_rows * two_c;
    ga.colbias = a.colbias ? a.colbias + l * two_c : nullptr;
    ga.rowbias = a.rowbias ? a.rowbias + (size_t)l * a.M * two_c : nullptr;
    ga.g = a.g;
    ga.M = a.M;
    ga.T = a.T;
    ga.C = a.C;
    ga.taps = a.taps;
    ga.dil = a.dil[l];
    gate_kernel<<<grid, NT, SMEM_BYTES, stream>>>(ga);

    OutArgs oa;
    oa.g = a.g;
    oa.w = a.wo + (size_t)l * a.C * two_c;
    oa.bo = a.bo + l * two_c;
    oa.x = a.x;
    oa.skip = a.skip;
    oa.y = a.y;
    oa.tb_next = l + 1 < a.L ? a.tb + (size_t)(l + 1) * a.tb_ls : nullptr;
    oa.tb_bs = a.tb_bs;
    oa.M = a.M;
    oa.T = a.T;
    oa.C = a.C;
    oa.accumulate = l > 0;
    oa.scale = l == a.L - 1 ? 1.0f / sqrtf((float)a.L) : 1.0f;
    out_kernel<<<grid, NT, SMEM_BYTES, stream>>>(oa);
  }
  return cudaGetLastError();
}

}  // namespace drk

extern "C" {

const char* drk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// K1 entry: one pass of the stack. Pointers are device pointers except
// `dil` (a host int[L]); see drk::StackArgs for shapes.
int drk_gated_stack(void* x, void* skip, void* g, void* y, const void* tb, int tb_ls, int tb_bs,
                    const void* cond, int mp, const void* wcat, int w_rows,
                    const void* colbias, const void* rowbias, const void* wo,
                    const void* bo, const void* dil, int L, int M, int T, int C, int taps,
                    void* stream) {
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
  return (int)drk::launch_stack(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
