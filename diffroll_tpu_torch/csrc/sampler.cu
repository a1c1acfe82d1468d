// The whole reverse-diffusion process, hand-written for Hopper (sm_90a).
//
// Replaces diffroll_tpu/ops/sampler_kernel.py::fused_sample_pallas (the
// Pallas TPU kernel; body `_make_kernel`). Every reference sampler step is
// linear in (prediction, x, noise):  x <- a[s]*pred + b[s]*x + sigma[s]*noise[s]
// with per-step scalars from `sampler_tables`, and classifier-free guidance
// runs the conditional and unconditional streams as the two row halves of
// one batch: rows [0, R) conditional, [R, 2R) unconditional (spec := -1).
//
// The TPU kernel keeps every weight on chip for the whole run. Hopper
// cannot: the flagship's weights are ~70 MB in bf16 against 50 MB of L2 and
// 227 KB of shared memory per block. So the process is a host loop over
// steps (the wrapper in ops/sampler_kernel.py) of three launches:
//   once per clip  drk_cond_proj: cond2 @ Wc[l] + b[l] + bc[l] for both
//                  streams and all L layers, by the tile GEMM of
//                  gated_stack.cuh, stored in f32 (L, 2R, 2C) and used as
//                  the gate kernel's per-row bias (the TPU rounds this
//                  hoisted term to bf16; f32 here keeps it exact);
//   per step       drk_head_in: relu(x @ Win + bin) in f32, written as bf16
//                  into every stream's rows;
//                  drk::launch_stack: the L gated layers (K1's device code);
//                  drk_head_out: relu(skip @ Wskip + bskip) @ Wout + bout in
//                  f32, the guidance mix (1+w) c - w u, and the table update
//                  of x in place, for step index `step`.
// Bound on this card: compute, as for K1 (the stack is ~97% of a step's
// FLOPs); the f32 heads are small products on the CUDA cores.

#include "gated_stack.cuh"

namespace drk {

struct ProjArgs {
  const bf16* a;     // (M, lda) padded conditioner
  int lda, K;
  const bf16* w;     // layer 0's conditioner rows; layer l at w + l * w_ls
  size_t w_ls;
  const float* bias; // (L, 2C)
  float* out;        // (L, M, 2C)
  int M, C;
};

__global__ void __launch_bounds__(NT) proj_kernel(ProjArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int l = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const RowSrc src{p.a, p.lda, m0, p.M};
  gemm_tile(src, p.w + l * p.w_ls, 2 * p.C, n0, p.C + n0, p.K, smem);

  const float* Cs = reinterpret_cast<const float*>(smem);
  const float* bias = p.bias + (size_t)l * 2 * p.C;
  float* out = p.out + (size_t)l * p.M * 2 * p.C;
  for (int v = threadIdx.x; v < BM * 2 * BN; v += NT) {
    const int r = v / (2 * BN), c = v % (2 * BN);
    const int m = m0 + r;
    if (m >= p.M) continue;
    const int n = c < BN ? n0 + c : p.C + n0 + c - BN;
    out[(size_t)m * 2 * p.C + n] = Cs[r * C_LD + c] + bias[n];
  }
}

constexpr int HEAD_ROWS = 8;      // rows (per stream) per head block
constexpr int HEAD_THREADS = 256;

// out[s * R + m, :] = bf16(relu(x[m, :] @ win + bin)) for every stream s.
__global__ void __launch_bounds__(HEAD_THREADS)
head_in_kernel(const float* __restrict__ x, const float* __restrict__ win,
               const float* __restrict__ bin, bf16* __restrict__ out,
               int R, int P, int C, int S) {
  extern __shared__ float xs[];  // (HEAD_ROWS, P)
  const int m0 = blockIdx.x * HEAD_ROWS;
  for (int i = threadIdx.x; i < HEAD_ROWS * P; i += blockDim.x) {
    const int m = m0 + i / P;
    xs[i] = m < R ? x[(size_t)m * P + i % P] : 0.0f;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc[HEAD_ROWS];
#pragma unroll
    for (int r = 0; r < HEAD_ROWS; ++r) acc[r] = 0.0f;
    for (int k = 0; k < P; ++k) {
      const float wv = win[(size_t)k * C + c];
#pragma unroll
      for (int r = 0; r < HEAD_ROWS; ++r) acc[r] += xs[r * P + k] * wv;
    }
#pragma unroll
    for (int r = 0; r < HEAD_ROWS; ++r) {
      const int m = m0 + r;
      if (m >= R) break;
      const bf16 h = __float2bfloat16(fmaxf(acc[r] + bin[c], 0.0f));
      for (int s = 0; s < S; ++s) out[((size_t)s * R + m) * C + c] = h;
    }
  }
}

// pred = relu(skip @ wskip + bskip) @ wout + bout per stream row; guided
// (S == 2): pred = (1+w) pred_cond - w pred_uncond; then
// x <- a*pred + b*x + sigma*noise. A block owns HEAD_ROWS rows of every
// stream, held in shared memory. Both products are register-blocked over
// those rows and read 4 consecutive k at once (float4 from shared memory),
// so each weight load feeds 4 * S * HEAD_ROWS FMAs and several loads are in
// flight per thread. Needs C % 4 == 0.
template <int S>
__global__ void __launch_bounds__(HEAD_THREADS)
head_out_kernel(const float* __restrict__ skip, const float* __restrict__ wskip,
                const float* __restrict__ bskip, const float* __restrict__ wout,
                const float* __restrict__ bout, float* __restrict__ x,
                const float* __restrict__ noise, const float* __restrict__ tables,
                int step, int R, int P, int C, float wg) {
  constexpr int NR = S * HEAD_ROWS;
  constexpr int KSPLIT = 2;  // the output product splits its k range in two
  extern __shared__ float sm[];
  float* sk = sm;            // (NR, C) skip rows
  float* hs = sk + NR * C;   // (NR, C) hidden
  float* pr = hs + NR * C;   // (KSPLIT, NR, P) partial predictions
  const int m0 = blockIdx.x * HEAD_ROWS;
  for (int i = threadIdx.x; i < NR * C; i += blockDim.x) {
    const int rr = i / C, c = i % C;
    const int m = m0 + rr % HEAD_ROWS;
    sk[i] = m < R ? skip[((size_t)(rr / HEAD_ROWS) * R + m) * C + c] : 0.0f;
  }
  __syncthreads();

  // hs = relu(sk @ wskip + bskip): two adjacent columns per thread
  for (int c = 2 * threadIdx.x; c < C; c += 2 * blockDim.x) {
    float acc0[NR], acc1[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) acc0[r] = acc1[r] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < C; k += 4) {
      float2 wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = *reinterpret_cast<const float2*>(wskip + (size_t)(k + q) * C + c);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float4 s4 = *reinterpret_cast<const float4*>(sk + r * C + k);
        acc0[r] += s4.x * wv[0].x + s4.y * wv[1].x + s4.z * wv[2].x + s4.w * wv[3].x;
        acc1[r] += s4.x * wv[0].y + s4.y * wv[1].y + s4.z * wv[2].y + s4.w * wv[3].y;
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      hs[r * C + c] = fmaxf(acc0[r] + bskip[c], 0.0f);
      hs[r * C + c + 1] = fmaxf(acc1[r] + bskip[c + 1], 0.0f);
    }
  }
  __syncthreads();

  // partial predictions over one half of k: one pitch per thread, all rows
  const int kc = C / KSPLIT;
  for (int i = threadIdx.x; i < KSPLIT * P; i += blockDim.x) {
    const int p = i % P, part = i / P;
    float acc[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] = 0.0f;
#pragma unroll 2
    for (int k = part * kc; k < (part + 1) * kc; k += 4) {
      float wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[q] = wout[(size_t)(k + q) * P + p];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float4 h4 = *reinterpret_cast<const float4*>(hs + r * C + k);
        acc[r] += h4.x * wv[0] + h4.y * wv[1] + h4.z * wv[2] + h4.w * wv[3];
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) pr[(part * NR + r) * P + p] = acc[r];
  }
  __syncthreads();

  const float a = tables[3 * step], b = tables[3 * step + 1], sg = tables[3 * step + 2];
  for (int i = threadIdx.x; i < HEAD_ROWS * P; i += blockDim.x) {
    const int r = i / P, p = i % P;
    const int m = m0 + r;
    if (m >= R) continue;
    float pred = pr[r * P + p] + pr[(NR + r) * P + p] + bout[p];
    if (S == 2) {
      const float u = pr[(HEAD_ROWS + r) * P + p] + pr[(NR + HEAD_ROWS + r) * P + p] + bout[p];
      pred = (1.0f + wg) * pred - wg * u;
    }
    const size_t idx = (size_t)m * P + p;
    float v = a * pred + b * x[idx];
    if (noise) v += sg * noise[(size_t)step * R * P + idx];
    x[idx] = v;
  }
}

template <int S>
cudaError_t launch_head_out(const float* skip, const float* wskip, const float* bskip,
                            const float* wout, const float* bout, float* x,
                            const float* noise, const float* tables, int step, int R, int P,
                            int C, float wg, cudaStream_t stream) {
  constexpr int NR = S * HEAD_ROWS;
  const size_t smem = (size_t)(2 * NR * C + 2 * NR * P) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        head_out_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (R + HEAD_ROWS - 1) / HEAD_ROWS;
  head_out_kernel<S><<<blocks, HEAD_THREADS, smem, stream>>>(
      skip, wskip, bskip, wout, bout, x, noise, tables, step, R, P, C, wg);
  return cudaGetLastError();
}

}  // namespace drk

extern "C" {

// Once per clip: out[l] = cond @ wcat[l, k_off : k_off + mp] + bias[l], f32.
int drk_cond_proj(const void* cond, int mp, const void* wcat, int w_rows, int k_off,
                  const void* bias, void* out, int L, int M, int C, void* stream) {
  drk::ProjArgs p;
  p.a = static_cast<const drk::bf16*>(cond);
  p.lda = mp;
  p.K = mp;
  p.w = static_cast<const drk::bf16*>(wcat) + (size_t)k_off * 2 * C;
  p.w_ls = (size_t)w_rows * 2 * C;
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.C = C;
  const cudaError_t e = cudaFuncSetAttribute(
      drk::proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, drk::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(C / drk::BN, (M + drk::BM - 1) / drk::BM, L);
  drk::proj_kernel<<<grid, drk::NT, drk::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

int drk_head_in(const void* x, const void* win, const void* bin, void* out, int R, int P,
                int C, int S, void* stream) {
  const int blocks = (R + drk::HEAD_ROWS - 1) / drk::HEAD_ROWS;
  const size_t smem = (size_t)drk::HEAD_ROWS * P * sizeof(float);
  drk::head_in_kernel<<<blocks, drk::HEAD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<const float*>(bin), static_cast<drk::bf16*>(out), R, P, C, S);
  return (int)cudaGetLastError();
}

int drk_head_out(const void* skip, const void* wskip, const void* bskip, const void* wout,
                 const void* bout, void* x, const void* noise, const void* tables, int step,
                 int R, int P, int C, int S, float wg, void* stream) {
  if (C % 4) return (int)cudaErrorInvalidValue;
  auto launch = S == 2 ? drk::launch_head_out<2> : drk::launch_head_out<1>;
  return (int)launch(static_cast<const float*>(skip), static_cast<const float*>(wskip),
                     static_cast<const float*>(bskip), static_cast<const float*>(wout),
                     static_cast<const float*>(bout), static_cast<float*>(x),
                     static_cast<const float*>(noise), static_cast<const float*>(tables),
                     step, R, P, C, wg, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
