// The Hopper tile GEMM of the gated stack's forward kernels (gated_stack.cu):
// bf16 operands brought into shared memory by TMA, multiplied by wgmma, f32
// sums kept in registers until the caller's epilogue has finished them.
//
// A block is NWG consumer warpgroups and one producer warp. Its tile is
// BM = 64 * NWG frames of ONE sequence x the column pair (n0 .. n0+BN,
// C+n0 .. C+n0+BN) of a (K, 2C) row-major weight matrix, so a consumer
// thread holds both halves of a gate pair (sigmoid half, tanh half) or of an
// output pair (residual half, skip half) in its own registers.
//   * The producer's one thread walks the block's tiles and their k tiles
//     (BK = 64, one 128-byte swizzle row of bf16) and issues, per k tile, one
//     TMA load of the A box (64 k x BM frames x 1 sequence) and one per
//     weight box (64 columns x 64 k x 1 layer) into a STAGES-deep ring.
//     Completion is counted in bytes on the stage's `full` mbarrier; a stage
//     is reused when every consumer warpgroup has arrived on its `empty` one.
//     No thread computes an address for an element and no barrier is
//     block-wide.
//   * A is a 3-d tensor (channels, frames, sequences). A tap is the same box
//     at frame t0 + (j - taps/2) * dilation: what falls outside [0, T) of that
//     sequence, negative frames included, is zero-filled by the copy.
//   * The consumers run four wgmma.mma_async (m64 x n(2BN) x k16) per k tile:
//     A K-major and the weights MN-major (trans-b), both read through
//     shared-memory descriptors that name the tensor maps' swizzle. One k tile
//     stays in flight while the next is issued; a stage is released when the
//     wgmma that read it has completed.
//   * The ring runs on across the tiles of a persistent block, so the loads
//     of its next tile are in flight while the consumers finish a tile.
// Sums are taken in a fixed order by one warpgroup per output element: the
// same inputs give the same bits on every run.
// Registers: a block of 2 x 128 + 32 threads is granted 168 registers a thread,
// which holds the 64 accumulators and the epilogue with no spill to speak of
// (-Xptxas -v), so the roles trade no registers (no setmaxnreg).
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

// d (64 x N, f32, spread over the warpgroup) = or += A (64 x 16, K-major) @
// B (16 x N, N contiguous: trans-b), both bf16 in shared memory. Thread
// `tid` of the warpgroup holds, for every 8-column chunk j, d[4j], d[4j+1] at
// row 16 * (tid / 32) + (tid % 32) / 4, columns 8j + 2 * (tid % 4) + {0, 1},
// and d[4j+2], d[4j+3] eight rows below.
template <int N>
struct Wgmma;  // the shape the stack uses is spelled out below: N = 128

template <>
struct Wgmma<128> {
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
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
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
        : "l"(da), "l"(db), "r"(acc));
  }
};

// The ring and the two roles of one block.
template <int BN_, int NWG_, int STAGES_>
struct TileGemm {
  static constexpr int BN = BN_, NWG = NWG_, STAGES = STAGES_;
  static constexpr int BM = 64 * NWG;                  // frames per tile
  static constexpr int NBOX = 2 * BN / 64;             // weight boxes per stage, both halves
  static constexpr int BOX_BYTES = BK * 128;           // 64 k x 64 columns of bf16
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + NBOX * BOX_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int ACC = BN;                       // f32 per consumer thread: 64 x 2BN / 128
  static_assert(BN % 64 == 0, "whole 128-byte swizzle spans of weight columns");
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

  // Producer thread: the nk k tiles of one output tile. `a_box(kt, map, c0,
  // c1)` names the A box's tensor map, channel and frame; `seq` is its
  // sequence. Weight rows run on from k tile 0 of layer `layer`.
  template <class ABox>
  __device__ __forceinline__ void produce(const CUtensorMap* map_w, int layer, int n0, int C,
                                          int seq, int nk, ABox a_box, int& it) const {
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);  // passes at once on the first round
      mbar_expect_tx(full(s), STAGE_BYTES);
      const CUtensorMap* map_a;
      int c0, c1;
      a_box(kt, map_a, c0, c1);
      tma_load_3d(stage(s), map_a, full(s), c0, c1, seq);
#pragma unroll
      for (int bx = 0; bx < NBOX; ++bx) {
        const int col = (bx < NBOX / 2 ? n0 : C + n0 - BN) + bx * 64;
        tma_load_3d(stage(s) + A_BYTES + bx * BOX_BYTES, map_w, full(s), col, kt * BK, layer);
      }
    }
  }

  // Consumer warpgroup `wg`: d = A[64 wg .. +64, :] @ [W[:, n0..] | W[:, C+n0..]].
  // On return every wgmma has completed and d may be read.
  __device__ __forceinline__ void consume(float (&d)[ACC], int wg, int nk, int& it) const {
    const bool elected = threadIdx.x % 128 == 0;
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full(s), (it / STAGES) & 1);
      const uint64_t da = smem_desc(stage(s) + wg * 64 * 128, 16, 1024, 1);
      // A: K-major rows of 128 bytes, 8-row groups 1,024 bytes apart. Weights:
      // MN-major, 64 columns contiguous, 8 k rows 1,024 bytes apart, the next
      // 64 columns one box further.
      const uint64_t db = smem_desc(stage(s) + A_BYTES, BOX_BYTES, 1024, 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<2 * BN>::mma(d, da + kk * (32 >> 4), db + kk * (2048 >> 4), (kt | kk) != 0);
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

}  // namespace sm90
}  // namespace drk
