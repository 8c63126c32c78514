// Shared device code of the port's two FFN kernels (inference, bf16, sm_90a):
// the warp-level mma.sync / ldmatrix / cp.async helpers, and the F-tile loop
// of the 128 -> F -> 128 ReLU FFN that both csrc/fused_encoder.cu (the FFN
// half of the whole encoder layer) and csrc/fused_ffn.cu (the FFN alone)
// run.  One copy of the loop keeps the two kernels' arithmetic identical.
//
// The loop: a block of WARPS warps owns WARPS * 16 rows, each warp one m16
// tile whose A fragments (16 x 128 bf16) it holds in registers.  W1 (F, 128)
// and W2 (128, F) are streamed through shared memory in FT = 64-wide F-tiles,
// double-buffered with cp.async, so each weight byte fetched from L2 serves
// all rows of the block.  Per tile every warp computes its (16, 64) slice of
// relu(x W1^T + b1) in fp32 accumulators, rounds it to bf16 in registers (the
// accumulator layout of one mma is the A layout of the next) and accumulates
// its product with the W2 tile into the (16, 128) fp32 output: the (rows, F)
// activation never leaves the SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace s3d {

constexpr int D = 128;        // model width (FFN input and output)
constexpr int FT = 64;        // FFN F-tile
constexpr int LDW = D + 8;    // padded row of a (., 128) bf16 tile
constexpr int LDW2 = FT + 8;  // padded row of a (128, FT) W2 tile
// one FFN stage in shared memory, in bf16 elements: a W1 tile then a W2 tile
constexpr int STAGE = FT * LDW + D * LDW2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// A fragments (16 rows x 128 cols) of a row-major (16, LDW) bf16 tile.
__device__ __forceinline__ void load_a128(uint32_t (*a)[4], const __nv_bfloat16* tile,
                                          int lane) {
  const __nv_bfloat16* p = tile + (lane & 15) * LDW + (lane >> 4) * 8;
#pragma unroll
  for (int k = 0; k < D / 16; ++k) ldsm_x4(a[k][0], a[k][1], a[k][2], a[k][3], p + 16 * k);
}

// W1 rows f0 .. f0+FT (16 chunks of 16 B each), then W2[:, f0:f0+FT] (8
// chunks) -> one ring stage, by all THREADS threads of the block.
template <int THREADS>
__device__ __forceinline__ void ffn_stage(__nv_bfloat16* dst, const __nv_bfloat16* w1,
                                          const __nv_bfloat16* w2, int f, int f0,
                                          int tid) {
  for (int i = tid; i < FT * 16; i += THREADS) {
    const int r = i >> 4, c = (i & 15) * 8;
    cp_async16(dst + r * LDW + c, w1 + size_t(f0 + r) * D + c);
  }
  __nv_bfloat16* w2s = dst + FT * LDW;
  for (int i = tid; i < D * (FT / 8); i += THREADS) {
    const int r = i / (FT / 8), c = (i % (FT / 8)) * 8;
    cp_async16(w2s + r * LDW2 + c, w2 + size_t(r) * f + f0 + c);
  }
}

// out (16 x 128 fp32, zeroed by the caller) += relu(A W1^T + b1) W2^T for
// one warp's A fragments `ha`, streaming the F-tiles through `ring` (2 *
// STAGE bf16 elements of shared memory, free on entry, free again on exit).
// Every thread of the block calls it: it synchronises the block.
template <int THREADS>
__device__ __forceinline__ void ffn_accumulate(float (*out)[4], const uint32_t (*ha)[4],
                                               __nv_bfloat16* ring,
                                               const __nv_bfloat16* w1, const float* b1,
                                               const __nv_bfloat16* w2, int f, int tid,
                                               int lane) {
  const int n_tiles = f / FT;
  const int t4 = lane & 3;
  ffn_stage<THREADS>(ring, w1, w2, f, 0, tid);
  cp_async_commit();
  if (n_tiles > 1) ffn_stage<THREADS>(ring + STAGE, w1, w2, f, FT, tid);
  cp_async_commit();

  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;
#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* w1s = ring + (it & 1) * STAGE;
    const __nv_bfloat16* w2s = w1s + FT * LDW;
    const int f0 = it * FT;

    float hid[FT / 8][4];
#pragma unroll
    for (int j = 0; j < FT / 8; ++j) hid[j][0] = hid[j][1] = hid[j][2] = hid[j][3] = 0.f;
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
#pragma unroll
      for (int j = 0; j < FT / 16; ++j) {
        uint32_t b0, b1r, b2, b3;
        ldsm_x4(b0, b1r, b2, b3, w1s + (16 * j + brow) * LDW + 16 * k + bcol);
        mma(hid[2 * j], ha[k], b0, b1r);
        mma(hid[2 * j + 1], ha[k], b2, b3);
      }
    }
    // relu(. + b1) rounded to bf16: accumulator layout -> A fragments
    uint32_t fa[FT / 16][4];
#pragma unroll
    for (int j = 0; j < FT / 8; ++j) {
      const int c = f0 + 8 * j + 2 * t4;
      const float bb0 = __ldg(b1 + c), bb1 = __ldg(b1 + c + 1);
      fa[j >> 1][(j & 1) * 2 + 0] =
          pack_bf16(fmaxf(hid[j][0] + bb0, 0.f), fmaxf(hid[j][1] + bb1, 0.f));
      fa[j >> 1][(j & 1) * 2 + 1] =
          pack_bf16(fmaxf(hid[j][2] + bb0, 0.f), fmaxf(hid[j][3] + bb1, 0.f));
    }
#pragma unroll
    for (int k = 0; k < FT / 16; ++k) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1r, b2, b3;
        ldsm_x4(b0, b1r, b2, b3, w2s + (16 * j + brow) * LDW2 + 16 * k + bcol);
        mma(out[2 * j], fa[k], b0, b1r);
        mma(out[2 * j + 1], fa[k], b2, b3);
      }
    }
    __syncthreads();  // everyone is done with this stage
    if (it + 2 < n_tiles) ffn_stage<THREADS>(ring + (it & 1) * STAGE, w1, w2, f, f0 + 2 * FT,
                                             tid);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

}  // namespace s3d
