// The fp32 pieces of the SDF head's kernels on Hopper (sm_90a): a
// register-blocked SIMT product over a 128-row tile, the weight ring and the
// F-tile loop of the 128 -> F -> 128 ReLU FFN, shared by
// csrc/fused_encoder_f32.cu (the FFN half of the encoder layer) and
// csrc/fused_ffn_f32.cu (the FFN alone), so that both kernels' FFN is one
// code.
//
// True fp32: every product and sum is an fp32 FMA on the CUDA cores.  The
// tensor cores take fp32 only as TF32 (10 bits of mantissa), which these
// kernels must not use, so they are plain SIMT kernels, bounded by the
// card's fp32 FMA rate: 132 SMs x 128 lanes x 2 flops a clock, 66.9 TFLOP/s
// at 1980 MHz.
//
// Shape: a block of 256 threads takes a tile of ROWS = 128 rows of width
// D = 128 and keeps it in shared memory (X, row-major, rows padded to LDX
// floats so that the two row groups a warp reads at once sit in different
// banks).  Thread t owns rows ty * 4 + i and 64 + ty * 4 + i (i < 4, ty = t
// / 16) of every product, and 2, 4 or 8 of its columns (tx = t % 16): the
// classic SGEMM blocking.  Per 4 steps along K it reads its 8 rows as 8
// float4s (two addresses a warp, a broadcast) and each step's columns as
// float4s or float2s, and does 8 x NC FMAs a step, so shared memory feeds
// the FMA pipe without becoming the limit (8 x 8: 16 loads per 256 FMAs).
//
// Weights: a layer's fp32 weights are 2.36 MB (F = 2048), more than shared
// memory holds, so every tile streams them from L2 through a ring of stages
// filled by cp.async (asynchronous copies that land while the block
// computes on the stage before).  The wrapper packs each weight set once
// (slice3d_tpu_torch/ops/prepared.py) into the order and layout the kernels
// read: a stage is a K-major [K][cols] block, copied as it lies.
//
// The FFN, per F-tile of FT = 64 hidden columns (ffn_tile):
//   GEMM 1:  H (128 x 64) = relu(X W1[ft]^T + b1[ft])   -> shared memory
//   GEMM 2:  acc (128 x 128, registers) += H W2[:, ft]^T
// so the (rows, F) activation never reaches device memory.  A stage holds
// one W1 F-tile ([128][64], 32 KB) or one W2 F-tile ([64][128], 32 KB): the
// F-tile's 64 KB of weights feed 2 x 128 x 128 x 64 FMAs (4.2 MFLOP), which
// keeps L2 off the critical path.

#pragma once

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace s3d_f32 {

constexpr int D = 128;       // model width (rows of a tile are D wide)
constexpr int FT = 64;       // FFN F-tile: F must be a multiple of it
constexpr int ROWS = 128;    // rows of a tile
constexpr int STAGES = 3;    // depth of the FFN's weight ring
constexpr int THREADS = 256;
constexpr int LDX = D + 4;   // row stride (floats) of a row tile in shared memory
constexpr int LDH = FT + 4;  // row stride of the F-tile activation H
constexpr int FFN_STAGE = D * FT;  // floats in an FFN stage

// Row i (< 8) of thread row group ty, and column j (< NC) of thread column
// group tx, of a 128-row product.
__device__ __forceinline__ int tile_row(int ty, int i) { return (i < 4 ? 0 : 60) + ty * 4 + i; }

template <int NC>
__device__ __forceinline__ int tile_col(int tx, int j) {
  return NC == 8 ? (j < 4 ? 0 : 60) + tx * 4 + j : tx * NC + j;
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// acc[i][j] += sum over k < K of A[tile_row(i)][k] * B[k][tile_col(j)].
// A: shared, row-major, row stride lda; B: shared, [K][.] row-major, row
// stride ldb; both 16-byte aligned with strides a multiple of 4 (2 for B
// when NC = 2).
template <int NC, int K>
__device__ __forceinline__ void gemm(float (&acc)[8][NC], const float* A, int lda,
                                     const float* B, int ldb, int ty, int tx) {
  static_assert(NC == 2 || NC == 4 || NC == 8, "2, 4 or 8 columns a thread");
  static_assert(K % 4 == 0, "K a multiple of 4");
  const float* a0 = A + (ty * 4) * lda;
  const float* a1 = A + (64 + ty * 4) * lda;
  const float* b = B + tx * (NC == 8 ? 4 : NC);
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(a0 + i * lda + k);
      a[i + 4] = *reinterpret_cast<const float4*>(a1 + i * lda + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* br = b + (k + kk) * ldb;
      float bv[NC];
      if constexpr (NC == 8) {
        const float4 u = *reinterpret_cast<const float4*>(br);
        const float4 w = *reinterpret_cast<const float4*>(br + 64);
        bv[0] = u.x, bv[1] = u.y, bv[2] = u.z, bv[3] = u.w;
        bv[4] = w.x, bv[5] = w.y, bv[6] = w.z, bv[7] = w.w;
      } else if constexpr (NC == 4) {
        const float4 u = *reinterpret_cast<const float4*>(br);
        bv[0] = u.x, bv[1] = u.y, bv[2] = u.z, bv[3] = u.w;
      } else {
        const float2 u = *reinterpret_cast<const float2*>(br);
        bv[0] = u.x, bv[1] = u.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = lane_of(a[i], kk);
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
}

// Start copying rows [0, n) of a (., D) fp32 matrix at src (row stride ld
// floats, 16-byte aligned) into the tile X (row stride LDX) as one cp.async
// group; rows n .. ROWS - 1 are zeroed, so they compute finite values that
// are never stored.
__device__ __forceinline__ void load_rows(float* X, const float* src, size_t ld, int n) {
  for (int c = threadIdx.x; c < ROWS * D / 4; c += THREADS) {
    const int r = c / (D / 4), q = (c % (D / 4)) * 4;
    if (r < n)
      __pipeline_memcpy_async(X + r * LDX + q, src + r * ld + q, 16);
    else
      *reinterpret_cast<float4*>(X + r * LDX + q) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __pipeline_commit();
}

// A ring of NS slots of NF floats each, filled in order with the stages of
// a packed stream (stage s at src + s * NF, n stages in all).  Every thread
// copies its part of a stage by cp.async, one commit group a stage.  next()
// waits for this thread's copies of the next stage, meets the block (so all
// copies are visible and every thread is done with the stage before it),
// refills that stage's slot with the stage NS - 1 further on and returns the
// next stage.  Groups committed before init (a row tile) complete with the
// first stage.
template <int NS, int NF>
struct Ring {
  static_assert(NS >= 2 && NF % (4 * THREADS) == 0, "a stage is whole float4s a thread");
  float* slots;
  const float* src;
  int n, issued, used;

  __device__ void init(float* s, const float* stream, int count) {
    slots = s;
    src = stream;
    n = count;
    issued = used = 0;
    for (int i = 0; i < NS - 1; ++i) issue();
  }

  __device__ void issue() {
    if (issued < n) {
      float* dst = slots + (issued % NS) * NF;
      const float* from = src + size_t(issued) * NF;
#pragma unroll 4
      for (int c = threadIdx.x * 4; c < NF; c += THREADS * 4)
        __pipeline_memcpy_async(dst + c, from + c, 16);
    }
    __pipeline_commit();  // an empty group past the end keeps the count uniform
    ++issued;
  }

  __device__ const float* next() {
    __pipeline_wait_prior(NS - 2);
    __syncthreads();
    issue();
    return slots + (used++ % NS) * NF;
  }
};

using FfnRing = Ring<STAGES, FFN_STAGE>;

// Sum of v over the 16 lanes of a half-warp (one row group of a product).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// LayerNorm (eps 1e-5) of the thread's 8 x 8 block of 128-wide rows, in
// place, with the plain version's order: mean, mean of squared deviations,
// (v - mean) * rsqrt(var + eps) * g + b.
__device__ __forceinline__ void layer_norm(float (&v)[8][8], const float* g, const float* b,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[i][j];
    const float mu = sum16(s) / float(D);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) q = fmaf(v[i][j] - mu, v[i][j] - mu, q);
    const float r = rsqrtf(sum16(q) / float(D) + 1e-5f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col<8>(tx, j);
      v[i][j] = (v[i][j] - mu) * r * g[c] + b[c];
    }
  }
}

// acc (the thread's 8 x 8 block of the tile's 128 x 128 output) +=
// relu(X W1^T + b1) W2^T over f / FT F-tiles, whose W1 and W2 stages the
// ring delivers in turn.  X: the tile's inputs (row stride LDX); H: shared
// scratch of ROWS x LDH floats.
template <class R>
__device__ __forceinline__ void ffn_tile(float (&acc)[8][8], const float* X, float* H, R& ring,
                                         const float* __restrict__ b1, int f, int ty, int tx) {
#pragma unroll 1
  for (int ft = 0; ft < f; ft += FT) {
    float h[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[i][j] = 0.f;
    gemm<4, D>(h, X, LDX, ring.next(), FT, ty, tx);
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bias[j] = b1[ft + tile_col<4>(tx, j)];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(H + tile_row(ty, i) * LDH + tile_col<4>(tx, 0)) =
          make_float4(fmaxf(h[i][0] + bias[0], 0.f), fmaxf(h[i][1] + bias[1], 0.f),
                      fmaxf(h[i][2] + bias[2], 0.f), fmaxf(h[i][3] + bias[3], 0.f));
    // next() meets the block: H is whole before GEMM 2 reads it, and GEMM 2
    // is done with it before the next F-tile's GEMM 1 rewrites it
    gemm<8, FT>(acc, H, LDH, ring.next(), D, ty, tx);
  }
}

// Store rows [0, n) of the thread's 8 x 8 block of a 128 x 128 tile to
// dst (row-major, row stride D).
__device__ __forceinline__ void store_rows(float* dst, const float (&v)[8][8], int n, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_row(ty, i);
    if (r < n) {
      float* row = dst + size_t(r) * D;
      *reinterpret_cast<float4*>(row + tile_col<8>(tx, 0)) =
          make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
      *reinterpret_cast<float4*>(row + tile_col<8>(tx, 4)) =
          make_float4(v[i][4], v[i][5], v[i][6], v[i][7]);
    }
  }
}

// Blocks of `kernel` with `smem` bytes of dynamic shared memory an SM holds
// at once.  Returns 0 or a cudaError_t.
template <class Kernel>
int resident_blocks(Kernel kernel, int smem, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, smem);
  return int(e);
}

}  // namespace s3d_f32
