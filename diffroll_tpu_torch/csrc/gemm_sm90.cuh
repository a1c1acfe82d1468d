// The Hopper tile GEMM of the gated stack's kernels, forward (gated_stack.cu)
// and backward (gated_stack_train.cu): bf16 operands brought into shared memory
// by TMA, multiplied by wgmma, f32 sums kept in registers until the caller's
// epilogue has finished them.
//
// A block is NWG consumer warpgroups and one producer warp. Its tile is
// BM = 64 * NWG rows x 2 * BN columns; consumer warpgroup `wg` owns rows
// 64 wg .. 64 wg + 63 and all the columns, so a consumer thread can hold both
// halves of a gate pair or of an output pair in its own registers.
//   * The producer's one thread walks the block's tiles and their k tiles
//     (BK = 64) and starts, per k tile, the TMA loads of the A boxes and of the
//     B boxes into a STAGES-deep ring. The caller names every box (tensor map
//     and coordinates) through two callbacks. Completion is counted in bytes on
//     the stage's `full` mbarrier; a stage is reused when every consumer
//     warpgroup has arrived on its `empty` one. No thread computes an address
//     for an element and no barrier is block-wide.
//   * Every box is 64 elements (128 bytes, one swizzle span) wide. What a box
//     holds outside its tensor, negative coordinates included, is zero-filled
//     by the copy: that is how taps stop at a sequence's ends.
//   * Operand layouts, template arguments TA and TB (wgmma's transpose flags):
//       A K-major  (TA = 0): one box of 64 k x BM rows            (forward; dy, dg, dcond)
//       A MN-major (TA = 1): NWG boxes of 64 rows x 64 k          (wgrad)
//       B MN-major (TB = 1): 2BN/64 boxes of 64 columns x 64 k    (forward; wgrad)
//       B K-major  (TB = 0): 2BN/64 boxes of 64 k x 64 columns    (dy, dg, dcond)
//     K-major: rows of 128 bytes, 8-row groups 1,024 bytes apart, 16 k further
//     is 32 bytes further. MN-major: k rows of 128 bytes (64 rows or columns
//     contiguous), 8-k groups 1,024 bytes apart, 16 k further is 2,048 bytes
//     further, the next 64 columns one 8 KB box further.
//   * The consumers run four wgmma.mma_async (m64 x n(2BN) x k16) per k tile.
//     One k tile stays in flight while the next is started; a stage is released
//     when the wgmma that read it has completed.
//   * The ring runs on across the tiles of a persistent block, so the loads
//     of its next tile are in flight while the consumers finish a tile.
// Sums are taken in a fixed order by one warpgroup per output element: the
// same inputs give the same bits on every run.
// Registers: a block of 2 x 128 + 32 threads is granted 168 registers a thread,
// which holds the 64 accumulators and the epilogue with no spill to speak of
// (-Xptxas -v), so the roles trade no registers (no setmaxnreg).
// That is the cooperative schedule (TileGemm::consume): both consumer
// warpgroups run one tile's k loop and then its epilogue, and the tensor
// cores wait out the epilogue. The backward's kernels keep it. The forward's
// two GEMMs take PingPongGemm below where a block walks two tiles or more:
// the same tile, ring and producer, but each consumer warpgroup owns whole
// tiles in turn and its epilogue runs under the other's k loop.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder itself is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace drk {
namespace sm90 {

constexpr int BK = 64;  // k per stage, bf16: 128 bytes, the swizzle span of an A row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers (addresses are shared-window u32)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the barrier has left the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA: one box of a 3-d tensor map into shared memory
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Fetch a tensor map ahead of its first use.
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- wgmma
// Shared-memory matrix descriptor: address, leading and stride byte offsets
// (all >> 4) and the swizzle (1: 128 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int lbo, int sbo, int swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swizzle << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x N, f32, spread over the warpgroup) = or += A (64 x 16) @ B (16 x N),
// both bf16 in shared memory, each K-major or MN-major. Thread
// `tid` of the warpgroup holds, for every 8-column chunk j, d[4j], d[4j+1] at
// row 16 * (tid / 32) + (tid % 32) / 4, columns 8j + 2 * (tid % 4) + {0, 1},
// and d[4j+2], d[4j+3] eight rows below.
template <int N>
struct Wgmma;  // the shape the stack uses is spelled out below: N = 128

template <>
struct Wgmma<128> {
  // TA / TB: 1 where the operand lies MN-major in shared memory (the
  // instruction's transpose flags), 0 where it lies K-major.
  template <int TA, int TB>
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

// tanh on the special-function unit: tanh.approx.f32 (one instruction, error
// ~2^-11, below the bf16 rounding of what it feeds), and sigmoid(a) =
// (1 + tanh(a / 2)) / 2. expf and tanhf cost some 60 instructions a value,
// and 128 values a thread a tile ran as long as two thirds of the tile's
// products while the tensor cores stood idle.
__device__ __forceinline__ float tanh_fast(float a) {
  float r;
  asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ float sigmoid_fast(float a) { return 0.5f * tanh_fast(0.5f * a) + 0.5f; }

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The accumulator rows of a consumer thread inside its block's tile: `row`
// and `row + 8`; its columns inside every 8-column chunk: `col`, `col + 1`.
struct Lane {
  int wg, row, col;
};
__device__ __forceinline__ Lane lane_of_thread() {
  const int t = threadIdx.x % 128;
  const int wg = threadIdx.x / 128;
  return {wg, wg * 64 + (t / 32) * 16 + (t % 32) / 4, 2 * (t % 4)};
}

// A 4 x 4 transpose of 32-bit values across a quad of lanes (the four lanes
// that share an accumulator row): lane q gives v[c] for c = 0..3 and gets
// v[i] = lane i's v[q]. An epilogue turns "my two columns of four 8-column
// chunks" into "all eight columns of chunk q" with it, so that it moves 16
// bytes a lane to and from device memory instead of 4. Every lane of the warp
// must call it.
__device__ __forceinline__ void quad_transpose(unsigned int (&v)[4]) {
  const bool odd = threadIdx.x & 1, hi = threadIdx.x & 2;
  // with lane q ^ 1: an even lane keeps chunks 0 and 2 of the pair, an odd one 1 and 3
  const unsigned int s0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  const unsigned int s1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  const unsigned int a0 = odd ? s0 : v[0], a1 = odd ? v[1] : s0;
  const unsigned int b0 = odd ? s1 : v[2], b1 = odd ? v[3] : s1;
  // with lane q ^ 2: lanes 0 and 1 keep the lower chunk, lanes 2 and 3 the upper
  const unsigned int t0 = __shfl_xor_sync(0xffffffffu, hi ? a0 : b0, 2);
  const unsigned int t1 = __shfl_xor_sync(0xffffffffu, hi ? a1 : b1, 2);
  v[0] = hi ? t0 : a0;
  v[1] = hi ? t1 : a1;
  v[2] = hi ? b0 : t0;
  v[3] = hi ? b1 : t1;
}

__device__ __forceinline__ unsigned int pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned int*>(&h);
}
__device__ __forceinline__ float2 unpack_bf16x2(unsigned int u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// The ring and the two roles of one block.
template <int BN_, int NWG_, int STAGES_, int TA_ = 0, int TB_ = 1>
struct TileGemm {
  static constexpr int BN = BN_, NWG = NWG_, STAGES = STAGES_, TA = TA_, TB = TB_;
  static constexpr int BM = 64 * NWG;                  // rows per tile
  static constexpr int NBOX = 2 * BN / 64;             // B boxes per stage
  static constexpr int NABOX = TA ? NWG : 1;           // A boxes per stage
  static constexpr int BOX_BYTES = BK * 128;           // 64 x 64 of bf16
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + NBOX * BOX_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int ACC = BN;                       // f32 per consumer thread: 64 x 2BN / 128
  static_assert(BN % 64 == 0, "whole 128-byte swizzle spans of columns");
  static_assert(STAGE_BYTES % 1024 == 0, "stages stay 1,024-byte aligned");

  uint32_t base;  // the ring, 1,024-byte aligned; the barriers follow it

  __device__ __forceinline__ uint32_t stage(int s) const { return base + s * STAGE_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base + STAGES * STAGE_BYTES + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const { return full(STAGES + s); }

  // Every thread of the block, once, before the roles part.
  __device__ __forceinline__ void init(unsigned char* smem_raw) {
    base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), NWG);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // Producer thread: the nk k tiles of one output tile. `a_box(kt, i, map, c0,
  // c1, c2)` names A box i of k tile kt (tensor map and coordinates, innermost
  // first), `b_box` the same for B box i.
  template <class ABox, class BBox>
  __device__ __forceinline__ void produce(int nk, ABox a_box, BBox b_box, int& it) const {
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);  // passes at once on the first round
      mbar_expect_tx(full(s), STAGE_BYTES);
      const CUtensorMap* map;
      int c0, c1, c2;
#pragma unroll
      for (int i = 0; i < NABOX; ++i) {
        a_box(kt, i, map, c0, c1, c2);
        tma_load_3d(stage(s) + i * (A_BYTES / NABOX), map, full(s), c0, c1, c2);
      }
#pragma unroll
      for (int i = 0; i < NBOX; ++i) {
        b_box(kt, i, map, c0, c1, c2);
        tma_load_3d(stage(s) + A_BYTES + i * BOX_BYTES, map, full(s), c0, c1, c2);
      }
    }
  }

  // Consumer warpgroup `wg`: d = A[64 wg .. +64, :] @ B over nk k tiles.
  // On return every wgmma has completed and d may be read.
  __device__ __forceinline__ void consume(float (&d)[ACC], int wg, int nk, int& it) const {
    const bool elected = threadIdx.x % 128 == 0;
    // bytes from one k16 slice of a stage to the next
    constexpr int A_STEP = TA ? 2048 : 32, B_STEP = TB ? 2048 : 32;
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full(s), (it / STAGES) & 1);
      // K-major: the leading offset is not read under the 128-byte swizzle.
      // MN-major: it is the step to the next 64 rows or columns (one box).
      const uint64_t da = TA ? smem_desc(stage(s) + wg * BOX_BYTES, BOX_BYTES, 1024, 1)
                             : smem_desc(stage(s) + wg * 64 * 128, 16, 1024, 1);
      const uint64_t db = TB ? smem_desc(stage(s) + A_BYTES, BOX_BYTES, 1024, 1)
                             : smem_desc(stage(s) + A_BYTES, 16, 1024, 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<2 * BN>::template mma<TA, TB>(d, da + kk * (A_STEP >> 4), db + kk * (B_STEP >> 4),
                                            (kt | kk) != 0);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();  // k tile kt - 1 has been read: its stage may be refilled
        if (elected) mbar_arrive(empty(prev));
      }
      prev = s;
    }
    wgmma_wait<0>();
    if (elected && prev >= 0) mbar_arrive(empty(prev));
  }
};

// setmaxnreg: a warpgroup gives up or takes registers of the block's pool.
// Every warp of the warpgroup executes it, on a path that never rejoins the
// other roles' (or ptxas ignores it).
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The ping-pong schedule of the forward GEMMs (gate_kernel, out_kernel): the
// tile (BM = 128 rows x a pair of BN columns, A K-major, B MN-major), the ring
// and the producer of TileGemm<BN, 2, STAGES>, but each consumer warpgroup
// owns whole tiles, so one tile's epilogue runs while the other warpgroup
// multiplies the next.
//   * Roles: consumer warpgroups 0 and 1 (threads 0-255), then a producer
//     warpgroup (256-383) whose first thread issues every copy. The producer
//     gives its registers up to 40 a thread and the consumers take 232 (the
//     block's 384 x 168 at launch): a tile's 128 f32 sums a thread and its
//     epilogue.
//   * Walk: block b's tiles are b + j * gridDim.x, j = 0, 1, ...; the producer
//     loads their k tiles in that order and consumer warpgroup j % 2 takes
//     tile j, reading ring positions j nk .. j nk + nk - 1. A stage is read by
//     one warpgroup, so its `empty` barrier waits for one arrival.
//   * Order: warpgroup w waits on `order(w)` for its turn, issues its tile's
//     k loop (two m64 x n(2BN) x k16 wgmma a k16 slice, one for each 64 rows),
//     then arrives on the other's `order` while its last k tile is still in
//     flight, waits for its own products and runs its epilogue. Turns strictly
//     alternate, so a parity wait is never a phase behind.
//   * Sums: every output element is summed by one warpgroup, by the same
//     instruction over the same shared-memory operands in the same k order as
//     under the cooperative TileGemm::consume: the two schedules give the
//     same bits.
template <int BN_, int STAGES_>
struct PingPongGemm : TileGemm<BN_, 2, STAGES_> {
  using Base = TileGemm<BN_, 2, STAGES_>;
  using Base::A_BYTES;
  using Base::BOX_BYTES;
  using Base::BN;
  using Base::STAGES;
  static constexpr int CONSUMERS = 2 * 128;  // threads of the two consumer warpgroups
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int SMEM_BYTES = Base::SMEM_BYTES + 16;  // the two order barriers
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static_assert(CONSUMERS * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536, "one block an SM");

  __device__ __forceinline__ uint32_t order(int wg) const { return this->full(2 * STAGES + wg); }

  __device__ __forceinline__ void init(unsigned char* smem_raw) {
    this->base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(this->full(s), 1);
        mbar_init(this->empty(s), 1);
      }
      mbar_init(order(0), 128);
      mbar_init(order(1), 128);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // Consumer warpgroup threadIdx.x / 128 over its tiles of the block's walk:
  // `start(tile)` runs before the tile's turn (loads issued there land while
  // the warpgroup waits and multiplies), then `finish(tile, row0, d)` finishes
  // rows row0 .. row0 + 63 of the tile from their sums d (Wgmma's layout), for
  // row0 = 0 and then 64.
  template <class Start, class Finish>
  __device__ __forceinline__ void consume_tiles(int ntiles, int nk, Start start,
                                                Finish finish) const {
    const int wg = threadIdx.x / 128;
    const bool elected = threadIdx.x % 128 == 0;
    constexpr int A_HALF = 64 * 128;  // bytes from row 0 of a K-major A box to row 64
    int turn = 0;
    for (int j = wg; (int)blockIdx.x + j * (int)gridDim.x < ntiles; j += 2, ++turn) {
      const int tile = (int)blockIdx.x + j * (int)gridDim.x;
      start(tile);
      float d[2][Base::ACC];
      mbar_wait(order(wg), (turn & 1) ^ wg ^ 1);  // warpgroup 0's first turn passes at once
      int it = j * nk, prev = -1;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(this->full(s), (it / STAGES) & 1);
        const uint64_t da = smem_desc(this->stage(s), 16, 1024, 1);
        const uint64_t db = smem_desc(this->stage(s) + A_BYTES, BOX_BYTES, 1024, 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            Wgmma<2 * BN>::template mma<0, 1>(d[r], da + ((r * A_HALF + kk * 32) >> 4),
                                              db + kk * (2048 >> 4), (kt | kk) != 0);
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();  // k tile kt - 1 has been read: its stage may be refilled
          if (elected) mbar_arrive(this->empty(prev));
        }
        prev = s;
      }
      mbar_arrive(order(wg ^ 1));  // the other warpgroup's turn: its k loop runs under our epilogue
      wgmma_wait<0>();
      if (elected) mbar_arrive(this->empty(prev));
      finish(tile, 0, d[0]);
      finish(tile, 64, d[1]);
    }
  }
};

}  // namespace sm90
}  // namespace drk
