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
// 227 KB of shared memory per block. So the process is a loop over steps of
// launches, and the loop runs here, in drk_sample_run: the host makes one
// call per reverse process. The stack's tensor maps and tile plan are built
// once, one step's launches are captured into a CUDA graph, and the graph is
// replayed once per step: a device counter, advanced by the step's first
// kernel, tells the later ones which time bias, table row and noise to read.
//   once per clip  drk_cond_proj: cond2 @ Wc[l] + b[l] + bc[l] for both
//                  streams and all L layers, by the wmma tile GEMM of
//                  gated_stack.cuh, stored in f32 (L, 2R, 2C) and used as
//                  the gate kernel's per-row bias (the TPU rounds this
//                  hoisted term to bf16; f32 here keeps it exact);
//   per step       head_in_kernel: relu(x @ Win + bin) in f32, written as
//                  bf16 into every stream's rows;
//                  drk::run_stack: the L gated layers (K1's device code);
//                  head_hidden_kernel: relu(skip @ Wskip + bskip) in f32;
//                  head_out_kernel: hidden @ Wout + bout in f32, the guidance
//                  mix (1+w) c - w u, and the table update of x in place.
// Bound on this card: operations, as for K1 (the stack is ~97% of a step's
// FLOPs). The heads stay f32 on the CUDA cores, as the TPU kernel keeps
// them: 0.79 GFLOP a step at B=1 against the 67 TFLOP/s f32 peak. Their
// larger product (C x C) is a shared-memory-tiled f32 GEMM of 64 x 64 tiles,
// (S R / 64) x (C / 64) = 160 blocks at B=1 on 132 SMs; the narrow ones
// (88 pitches) take 4 rows of every stream a block, R / 4 = 160 blocks, read
// their weights in 16-byte pieces and split k over the threads of a block, so
// that no thread waits on a long chain of loads from the L2.

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

constexpr int HEAD_ROWS = 4;      // rows (per stream) per head block: R / 4 blocks
constexpr int HEAD_THREADS = 256;

// out[s * R + m, :] = bf16(relu(x[m, :] @ win + bin)) for every stream s.
// A block owns HEAD_ROWS rows. A thread owns 4 adjacent columns (one float4
// weight load a k) over one half of k, so a row of `win` is read in 16-byte
// pieces and a thread's chain of loads is P / 2 long; the halves meet in
// shared memory. Needs C % 4 == 0.
// As the first kernel of a reverse step it also advances the device's step
// counter, which the step's later kernels read and this one does not.
__global__ void __launch_bounds__(HEAD_THREADS)
head_in_kernel(const float* __restrict__ x, const float* __restrict__ win,
               const float* __restrict__ bin, bf16* __restrict__ out,
               int R, int P, int C, int S, int* __restrict__ step) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                    // (HEAD_ROWS, P)
  float* red = sm + HEAD_ROWS * P;   // (HEAD_ROWS, C): the second half's partial sums
  const int m0 = blockIdx.x * HEAD_ROWS;
  if (blockIdx.x == 0 && threadIdx.x == 0) *step += 1;
  for (int i = threadIdx.x; i < HEAD_ROWS * P; i += blockDim.x) {
    const int m = m0 + i / P;
    xs[i] = m < R ? x[(size_t)m * P + i % P] : 0.0f;
  }
  __syncthreads();
  const int half = threadIdx.x / (HEAD_THREADS / 2);
  const int k0 = half ? P / 2 : 0, k1 = half ? P : P / 2;
  for (int c0 = 0; c0 < C; c0 += 2 * HEAD_THREADS) {  // 128 threads x 4 columns a pass
    const int c = c0 + (threadIdx.x % (HEAD_THREADS / 2)) * 4;
    float4 acc[HEAD_ROWS];
#pragma unroll
    for (int r = 0; r < HEAD_ROWS; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < C) {
#pragma unroll 11
      for (int k = k0; k < k1; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(win + (size_t)k * C + c);
#pragma unroll
        for (int r = 0; r < HEAD_ROWS; ++r) {
          const float xv = xs[r * P + k];
          acc[r].x += xv * wv.x;
          acc[r].y += xv * wv.y;
          acc[r].z += xv * wv.z;
          acc[r].w += xv * wv.w;
        }
      }
      if (half) {
#pragma unroll
        for (int r = 0; r < HEAD_ROWS; ++r) *reinterpret_cast<float4*>(red + r * C + c) = acc[r];
      }
    }
    __syncthreads();
    if (!half && c < C) {
      const float4 bv = *reinterpret_cast<const float4*>(bin + c);
#pragma unroll
      for (int r = 0; r < HEAD_ROWS; ++r) {
        const int m = m0 + r;
        if (m >= R) break;
        const float4 o = *reinterpret_cast<const float4*>(red + r * C + c);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(fmaxf(acc[r].x + o.x + bv.x, 0.0f),
                                                        fmaxf(acc[r].y + o.y + bv.y, 0.0f));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(fmaxf(acc[r].z + o.z + bv.z, 0.0f),
                                                        fmaxf(acc[r].w + o.w + bv.w, 0.0f));
        uint2 q;
        q.x = *reinterpret_cast<const unsigned*>(&lo);
        q.y = *reinterpret_cast<const unsigned*>(&hi);
        for (int st = 0; st < S; ++st)
          *reinterpret_cast<uint2*>(out + ((size_t)st * R + m) * C + c) = q;
      }
    }
    __syncthreads();  // `red` is reused by the next pass over the columns
  }
}

// hidden = relu(skip @ wskip + bskip), all f32: (M, C) @ (C, C), C % 64 == 0.
// A block of 256 threads owns a 64 x 64 tile and walks K in steps of 16
// through two shared-memory buffers (the next step's operands are fetched
// into registers while this one is multiplied); a thread owns 4 x 4 outputs.
constexpr int HT = 64, HK = 16;
__global__ void __launch_bounds__(HEAD_THREADS)
head_hidden_kernel(const float* __restrict__ skip, const float* __restrict__ wskip,
                   const float* __restrict__ bskip, float* __restrict__ hidden, int M, int C) {
  __shared__ __align__(16) float As[2][HK][HT + 4];  // k-major: As[k][row]
  __shared__ __align__(16) float Bs[2][HK][HT];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * HT, m0 = blockIdx.y * HT;
  const int a_row = tid / 4, a_k = (tid % 4) * 4;   // this thread's float4 of the A tile
  const int b_k = tid / 16, b_n = (tid % 16) * 4;   // ... and of the B tile
  const int ty = tid / 16, tx = tid % 16;
  const bool a_ok = m0 + a_row < M;
  const float* a_src = skip + (size_t)(a_ok ? m0 + a_row : 0) * C + a_k;
  const float* b_src = wskip + (size_t)b_k * C + n0 + b_n;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  float4 av = a_ok ? *reinterpret_cast<const float4*>(a_src) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 bv = *reinterpret_cast<const float4*>(b_src);
  const int nk = C / HK;
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    As[buf][a_k][a_row] = av.x;
    As[buf][a_k + 1][a_row] = av.y;
    As[buf][a_k + 2][a_row] = av.z;
    As[buf][a_k + 3][a_row] = av.w;
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) = bv;
    __syncthreads();  // the tile is whole; the other buffer's readers finished a step ago
    if (kt + 1 < nk) {
      if (a_ok) av = *reinterpret_cast<const float4*>(a_src + (kt + 1) * HK);
      bv = *reinterpret_cast<const float4*>(b_src + (size_t)(kt + 1) * HK * C);
    }
#pragma unroll
    for (int k = 0; k < HK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w}, b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
  }
  const float4 bias = *reinterpret_cast<const float4*>(bskip + n0 + tx * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) break;
    *reinterpret_cast<float4*>(hidden + (size_t)m * C + n0 + tx * 4) =
        make_float4(fmaxf(acc[i][0] + bias.x, 0.0f), fmaxf(acc[i][1] + bias.y, 0.0f),
                    fmaxf(acc[i][2] + bias.z, 0.0f), fmaxf(acc[i][3] + bias.w, 0.0f));
  }
}

// pred = hidden @ wout + bout per stream row; guided (S == 2):
// pred = (1+w) pred_cond - w pred_uncond; then x <- a*pred + b*x + sigma*noise
// for step *step. A block owns HEAD_ROWS rows of every stream, held in
// shared memory. A thread owns 4 adjacent pitches (one float4 weight load a
// k) over one OUT_KSPLIT-th of k for all those rows, so its chain of loads is
// C / OUT_KSPLIT long and each load feeds 4 * S * HEAD_ROWS FMAs; the partial
// sums meet in shared memory in a fixed order. Needs C % (4 * OUT_KSPLIT) == 0,
// P % 4 == 0 and P / 4 * OUT_KSPLIT <= HEAD_THREADS.
constexpr int OUT_KSPLIT = 8;
template <int S>
__global__ void __launch_bounds__(HEAD_THREADS)
head_out_kernel(const float* __restrict__ hidden, const float* __restrict__ wout,
                const float* __restrict__ bout, float* __restrict__ x,
                const float* __restrict__ noise, const float* __restrict__ tables,
                const int* __restrict__ step_ptr, int R, int P, int C, float wg) {
  constexpr int NR = S * HEAD_ROWS;
  extern __shared__ __align__(16) float sm[];
  float* hs = sm;            // (NR, C) hidden rows
  float* pr = hs + NR * C;   // (OUT_KSPLIT, NR, P) partial predictions
  const int m0 = blockIdx.x * HEAD_ROWS;
  for (int i = threadIdx.x; i < NR * C / 4; i += blockDim.x) {
    const int rr = (i * 4) / C, c = (i * 4) % C;
    const int m = m0 + rr % HEAD_ROWS;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < R)
      v = *reinterpret_cast<const float4*>(hidden + ((size_t)(rr / HEAD_ROWS) * R + m) * C + c);
    *reinterpret_cast<float4*>(hs + i * 4) = v;
  }
  __syncthreads();

  const int p4 = P / 4, kc = C / OUT_KSPLIT;
  if (threadIdx.x < p4 * OUT_KSPLIT) {
    const int p = (threadIdx.x % p4) * 4, part = threadIdx.x / p4;
    float4 acc[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
    for (int k = part * kc; k < (part + 1) * kc; k += 4) {
      float4 wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = *reinterpret_cast<const float4*>(wout + (size_t)(k + q) * P + p);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float4 h4 = *reinterpret_cast<const float4*>(hs + r * C + k);
        acc[r].x += h4.x * wv[0].x + h4.y * wv[1].x + h4.z * wv[2].x + h4.w * wv[3].x;
        acc[r].y += h4.x * wv[0].y + h4.y * wv[1].y + h4.z * wv[2].y + h4.w * wv[3].y;
        acc[r].z += h4.x * wv[0].z + h4.y * wv[1].z + h4.z * wv[2].z + h4.w * wv[3].z;
        acc[r].w += h4.x * wv[0].w + h4.y * wv[1].w + h4.z * wv[2].w + h4.w * wv[3].w;
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r)
      *reinterpret_cast<float4*>(pr + (part * NR + r) * P + p) = acc[r];
  }
  __syncthreads();

  const int step = *step_ptr;
  const float a = tables[3 * step], b = tables[3 * step + 1], sg = tables[3 * step + 2];
  for (int i = threadIdx.x; i < HEAD_ROWS * P; i += blockDim.x) {
    const int r = i / P, p = i % P;
    const int m = m0 + r;
    if (m >= R) continue;
    float pred = bout[p], u = bout[p];
#pragma unroll
    for (int part = 0; part < OUT_KSPLIT; ++part) {
      pred += pr[(part * NR + r) * P + p];
      if (S == 2) u += pr[(part * NR + HEAD_ROWS + r) * P + p];
    }
    if (S == 2) pred = (1.0f + wg) * pred - wg * u;
    const size_t idx = (size_t)m * P + p;
    float v = a * pred + b * x[idx];
    if (noise) v += sg * noise[(size_t)step * R * P + idx];
    x[idx] = v;
  }
}

// What one reverse process needs beside the stack's own arguments.
struct HeadArgs {
  float* x;             // (R, P) the sample, updated in place
  const float* noise;   // (n, R, P) or nullptr
  const float* tables;  // (n, 3)
  const float *win, *bin, *wskip, *bskip, *wout, *bout;
  float* hidden;        // (S R, C) scratch
  int* step;            // device: the step counter
  int R, P;
  float wg;
};

template <int S>
cudaError_t run_process(const StackPlan& plan, const HeadArgs& h, int n, cudaStream_t stream) {
  const StackArgs& a = plan.a;
  const int C = a.C;
  const size_t smem_in = (size_t)HEAD_ROWS * (h.P + C) * sizeof(float);
  const size_t smem_out = (size_t)(S * HEAD_ROWS) * (C + OUT_KSPLIT * h.P) * sizeof(float);
  static size_t smem_set = 48 * 1024;  // one-time set-up, not a call per launch
  if (smem_out > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        head_out_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_out);
    if (e != cudaSuccess) return e;
    smem_set = smem_out;
  }
  const int row_blocks = (h.R + HEAD_ROWS - 1) / HEAD_ROWS;
  const dim3 hidden_grid(C / HT, (a.M + HT - 1) / HT);
  // One reverse step on stream `st`. Nothing in it names the step: head_in
  // advances the device counter and the later kernels read it.
  auto one_step = [&](cudaStream_t st) {
    head_in_kernel<<<row_blocks, HEAD_THREADS, smem_in, st>>>(h.x, h.win, h.bin, a.x, h.R, h.P,
                                                              C, S, h.step);
    const cudaError_t e = run_stack(plan, a.tb, h.step, a.L * C, st);
    if (e != cudaSuccess) return e;
    head_hidden_kernel<<<hidden_grid, HEAD_THREADS, 0, st>>>(a.skip, h.wskip, h.bskip, h.hidden,
                                                             a.M, C);
    head_out_kernel<S><<<row_blocks, HEAD_THREADS, smem_out, st>>>(
        h.hidden, h.wout, h.bout, h.x, h.noise, h.tables, h.step, h.R, h.P, C, h.wg);
    return cudaGetLastError();
  };
  cudaError_t e = cudaMemsetAsync(h.step, 0xFF, sizeof(int), stream);  // -1: no step yet
  if (e != cudaSuccess) return e;
  // The step is captured once (3 + 1 + 2L launches) into a CUDA graph and
  // replayed n times: the host enqueues n graph launches, not n x 34 kernels
  // (measured on an H100 at B=1: the device idles 2.5-2.9% of a clip's span
  // instead of 10.1-10.2%, and the clip takes 8.5% less).
  cudaStream_t cap = nullptr;
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  e = cudaStreamCreateWithFlags(&cap, cudaStreamNonBlocking);
  if (e == cudaSuccess) e = cudaStreamBeginCapture(cap, cudaStreamCaptureModeThreadLocal);
  if (e == cudaSuccess) {
    const cudaError_t launched = one_step(cap);
    e = cudaStreamEndCapture(cap, &graph);
    if (launched != cudaSuccess) e = launched;
  }
  if (e == cudaSuccess) e = cudaGraphInstantiateWithFlags(&exec, graph, 0);
  for (int s = 0; s < n && e == cudaSuccess; ++s) e = cudaGraphLaunch(exec, stream);
  if (exec) cudaGraphExecDestroy(exec);  // freed once its launches have run
  if (graph) cudaGraphDestroy(graph);
  if (cap) cudaStreamDestroy(cap);
  return e;
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

// K2 entry: the whole reverse process of `n` steps, enqueued from here.
// x (R, P) f32 is updated in place into x_0; tb (n, L, C) f32, the same time
// bias for every row; tables (n, 3); noise (n, R, P) or null; xbuf (S R, C),
// g, y bf16 and skip, hidden f32 are (S R, C) scratch. The stack's other
// arguments are drk_gated_stack's. `dil` is a host int[L]; `step` a device
// int, the step counter; `passes` (host) receives the number of stack passes
// launched.
int drk_sample_run(void* x, const void* noise, const void* tables, int n, const void* tb,
                   const void* win, const void* bin, const void* wskip, const void* bskip,
                   const void* wout, const void* bout, float wg, void* xbuf, void* skip, void* g,
                   void* y, void* hidden, const void* wcat, int w_rows, const void* colbias,
                   const void* rowbias, const void* wo, const void* bo, const void* dil, int L,
                   int R, int T, int P, int C, int S, int taps, void* step, void* stream, void* passes) {
  if (C % 64 || P % 4 || P / 4 * drk::OUT_KSPLIT > drk::HEAD_THREADS || (S != 1 && S != 2) || n < 0)
    return (int)cudaErrorInvalidValue;
  drk::StackArgs a;
  a.x = static_cast<drk::bf16*>(xbuf);
  a.skip = static_cast<float*>(skip);
  a.g = static_cast<drk::bf16*>(g);
  a.y = static_cast<drk::bf16*>(y);
  a.tb = static_cast<const float*>(tb);
  a.tb_ls = C;
  a.tb_bs = 0;
  a.cond = nullptr;  // the conditioner's lanes are hoisted into `rowbias`
  a.mp = 0;
  a.wcat = static_cast<const drk::bf16*>(wcat);
  a.w_rows = w_rows;
  a.colbias = static_cast<const float*>(colbias);
  a.rowbias = static_cast<const float*>(rowbias);
  a.wo = static_cast<const drk::bf16*>(wo);
  a.bo = static_cast<const float*>(bo);
  a.dil = static_cast<const int*>(dil);
  a.L = L;
  a.M = S * R;
  a.T = T;
  a.C = C;
  a.taps = taps;
  drk::StackPlan plan;
  cudaError_t e = drk::plan_stack(a, &plan);
  if (e != cudaSuccess) return (int)e;
  drk::HeadArgs h;
  h.x = static_cast<float*>(x);
  h.noise = static_cast<const float*>(noise);
  h.tables = static_cast<const float*>(tables);
  h.win = static_cast<const float*>(win);
  h.bin = static_cast<const float*>(bin);
  h.wskip = static_cast<const float*>(wskip);
  h.bskip = static_cast<const float*>(bskip);
  h.wout = static_cast<const float*>(wout);
  h.bout = static_cast<const float*>(bout);
  h.hidden = static_cast<float*>(hidden);
  h.step = static_cast<int*>(step);
  h.R = R;
  h.P = P;
  h.wg = wg;
  auto run = S == 2 ? drk::run_process<2> : drk::run_process<1>;
  e = run(plan, h, n, static_cast<cudaStream_t>(stream));
  if (e == cudaSuccess) *static_cast<int*>(passes) = n;
  return (int)e;
}

}  // extern "C"
