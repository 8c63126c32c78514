// Fused post-LN transformer encoder layer for the SDF head (inference, bf16, sm_90a).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_encoder.py::fused_encoder_layer
// (pallas_call at :463, and :522 for kernel_variant="perhead"; bodies
// _layer_kernel_bdq :269, _layer_kernel_v2 :188, _layer_kernel_grouped :104
// and _layer_kernel :42, which all compute the same layer).  For every query
// point, over its T <= 16 tokens of width 128:
//
//   qkv  = x Wqkv^T + bqkv                        -> bf16
//   per head h (4 heads of 32): softmax(q_h k_h^T / sqrt(32))
//                                                 -> probs bf16, fp32 softmax
//   o    = probs v_h                              -> bf16
//   h1   = LN1(x + o Wo^T + bo)                   -> bf16   (eps 1e-5, fp32)
//   ff   = relu(h1 W1^T + b1)                     -> bf16
//   out  = LN2(h1 + ff W2^T + b2)                 -> bf16
//
// with `head_tokens = 1` keeping only token 0 after attention (the last layer
// of the head reads only that token).  The values are rounded to bf16 at the
// same places as _layer_kernel_bdq; every product accumulates in fp32.
//
// What bounds it on the H100: a full layer is ~15.4 MFLOP a point (88% of it
// the 128 -> 2048 -> 128 FFN) against ~6.7 KB of activations in and out, far
// above the card's ~295 operations a byte: the tensor cores, reached only
// through wgmma.  The weights (1.2 MB in bf16) do not fit in shared memory, so
// every tile of rows streams all of them from L2: 1.18 MB a tile, 4.4 GB a
// call at N = 33,800 with 9 points a tile (0.46 GB with head_tokens = 1),
// counted from the tiling.
//
// Design: csrc/ffn_tile.cuh's persistent warp-specialised blocks (two
// consumer warpgroups of 64 rows, one producer warpgroup) and weight ring.
// The producer streams, tile after tile, Wk, Wv, Wq, Wo (a 128 x 128 stage
// each) and then the W1/W2 F-tiles through the one ring, so the projections
// and the FFN read the weights the same way, and it loads the next tile's
// rows as soon as the out-projection has read this one's.
//   * head_tokens = 0.  Whole points are packed into a 128-row tile, P =
//     128 / T of them (9 at T = 13: 117 of 128 rows do work, against 8
//     points padded to 16 tokens, 104 of 128, in the design this replaces);
//     the 11 spare rows run through the products and are never stored.
//     The projections run on wgmma, each consumer warpgroup over its 64 rows
//     (k and v into a swizzled (rows, 256) buffer, q over x in place).  The
//     13 x 13 core of every (point, head) of the tile is spread over the 8
//     consumer warps on mma.sync, two items a warp at a time so their
//     latencies overlap (0.6% of the operations, yet one item a warp at a
//     time cost more than the projections; a point may straddle the two
//     warpgroups, so the block meets twice around it), and writes o over q.  Then each
//     warpgroup runs the out-projection, LN1, the F-tile loop and LN2 on its
//     64 rows with no block-wide break.
//   * head_tokens = 1.  A tile is at most 128 points, as few as keep the
//     rounds of blocks that 128 would take (265 tiles of 128 at N = 33,800
//     leave a third round of one tile; 394 of 86 fill three).  q, the
//     out-projection, LN1, the FFN and LN2 run on token 0 only (a (128, 128)
//     tile that one TMA box of stride T rows fetches), the FFN on one row a
//     point; k and v run for all tokens, over sub-tiles of P points, with Wk
//     and Wv held in the ring meanwhile and v's product under k's epilogue;
//     the one-query core runs on CUDA cores, a warp a (point, head).
// Clusters of two blocks that multicast every stage (half the weight bytes)
// read slower on the H100 (ffn_tile.cuh; PERF.md), so the blocks run alone,
// one an SM, each taking tiles blockIdx.x, + gridDim.x, ...  ptxas: 168
// registers a thread, no spills; dynamic shared memory 209,984 B a block
// (head_tokens = 0) and 230,464 B (head_tokens = 1).
//
// Only bf16 activations are taken, with D 128, 4 heads, 1 <= T <= 16 and F a
// positive multiple of 64; the Python wrapper
// (slice3d_tpu_torch/ops/fused_encoder.py) raises on anything else.  Plain C
// interface, built with nvcc into a shared library and bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "ffn_tile.cuh"

namespace {

using namespace s3d;

constexpr int NH = 4;       // heads
constexpr int DH = 32;      // head width
constexpr int MAX_T = 16;   // tokens a point: one m16 tile in the core

// Shared memory (bytes, from a 1024-byte boundary): the ring, then
//   X  (XR rows, swizzled (., 128)): x, then q over it, then o over q;
//      head_tokens = 1: token 0 of the tile's points, then a sub-tile's x
//   KV (KVR rows of 512 bytes: k in columns 0..127, v in 128..255, the
//      16-byte chunk c of row r at c ^ (r % 8)); head_tokens = 0 also holds
//      h1 (a swizzled (128, 128) tile) over its first 32 KB for the FFN
//   O  (head_tokens = 1: a swizzled (128, 128) tile): q of token 0, then o
//      over q, then h1 over o.
// With head_tokens = 0 the core reads up to 15 rows past a point's first,
// so X and KV carry 16 rows more than a tile, kept zero.
template <int HT>
struct Layout {
  static constexpr int XR = HT ? ROWS : ROWS + MAX_T;
  static constexpr int KVR = HT ? ROWS : ROWS + MAX_T;
  static constexpr int OFF_X = STAGES * STAGE_BYTES;
  static constexpr int OFF_KV = OFF_X + XR * D * 2;
  static constexpr int OFF_O = OFF_KV + KVR * 512;
  static constexpr int OFF_BAR = OFF_O + (HT ? ROWS * D * 2 : 0);
  static constexpr int SMEM = OFF_BAR + (2 * STAGES + 2) * 8 + 1024;  // + alignment slack
};
static_assert(Layout<0>::SMEM <= 232448 && Layout<1>::SMEM <= 232448,
              "shared memory over the per-block limit");
static_assert(Layout<0>::KVR * 512 >= ROWS * D * 2, "h1 must fit in the KV buffer");

__device__ __forceinline__ uint32_t kv_off(int r, int c) {  // c: 0..255
  return uint32_t(r * 512 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2);
}

// warp-level helpers of the head_tokens = 0 core
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NI (point, head) items of a packed tile at once, by one warp (the items'
// chains interleave, which hides their latencies): item i covers the
// point's rows rb[i] .. rb[i] + t - 1 (read as a 16-row tile; rows past t
// are other points' or zero, their keys masked and their outputs dropped)
// and head h[i].  q from X, k and v from KV; o (bf16) over q.  The softmax
// is fp32, exp(s - m) as exp2 of a prescaled logit on the special function
// units and one reciprocal of the row sum.
template <int NI>
__device__ __forceinline__ void core_mma(uint8_t* xs, const uint8_t* kvs, const int (&rb)[NI],
                                         const int (&h)[NI], int t, int lane) {
  constexpr int XR = Layout<0>::XR;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t xa = smem_u32(xs), kva = smem_u32(kvs);
  const float c = rsqrtf(float(DH)) * 1.4426950408889634f;  // scale log2(e)
  uint32_t qa[NI][2][4], kb[NI][2][4];
  float s[NI][2][4];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int row = rb[i] + (lane & 7) + ((lane >> 4) << 3);
    const int col = h[i] * DH + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      ldsm_x4(qa[i][k], xa + sw128(XR, rb[i] + (lane & 15), h[i] * DH + 16 * k + (lane >> 4) * 8));
      ldsm_x4(kb[i][k], kva + kv_off(row, col + 16 * k));
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      mma16816(s[i][0], qa[i][k], kb[i][k][0], kb[i][k][1]);
      mma16816(s[i][1], qa[i][k], kb[i][k][2], kb[i][k][3]);
    }
  }
  // fp32 softmax over the keys; keys past t get -1e9
  uint32_t pa[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t4 + e;
          v[2 * j + e] = col >= t ? -1e9f : s[i][j][2 * hh + e];
        }
      }
      float m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = exp2_approx((v[e] - m) * c);
        sum += v[e];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / sum;
      // A layout: a0/a2 = row g (keys 0-7 / 8-15), a1/a3 = row g + 8
      pa[i][hh] = pack_bf16(v[0] * inv, v[1] * inv);
      pa[i][hh + 2] = pack_bf16(v[2] * inv, v[3] * inv);
    }
  }
  float o[NI][4][4];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int row = rb[i] + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int col = D + h[i] * DH + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t b[4];
      ldsm_x4_t(b, kva + kv_off(row, col + 16 * j));
      o[i][2 * j][0] = o[i][2 * j][1] = o[i][2 * j][2] = o[i][2 * j][3] = 0.f;
      o[i][2 * j + 1][0] = o[i][2 * j + 1][1] = o[i][2 * j + 1][2] = o[i][2 * j + 1][3] = 0.f;
      mma16816(o[i][2 * j], pa[i], b[0], b[1]);
      mma16816(o[i][2 * j + 1], pa[i], b[2], b[3]);
    }
  }
  __syncwarp();  // every lane has read its q before o goes over it
#pragma unroll
  for (int i = 0; i < NI; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = g + 8 * hh;
      if (r >= t) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(xs + sw128(XR, rb[i] + r, h[i] * DH + 8 * j + 2 * t4)) =
            pack_bf16(o[i][j][2 * hh], o[i][j][2 * hh + 1]);
    }
  }
}

// One (point, head) with the single query of token 0, by one warp: lane j
// scores key j, lane d sums output column d.  q at row qr of the O tile, the
// point's keys at KV rows rb ..; o (bf16) over q.  Softmax as core_mma's.
__device__ __forceinline__ void core_one(uint8_t* os, const uint8_t* kvs, int qr, int rb, int h,
                                         int t, int lane) {
  const float c = rsqrtf(float(DH)) * 1.4426950408889634f;  // scale log2(e)
  float s = -INFINITY;
  if (lane < t) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < DH / 8; ++k) {
      const uint4 q4 = *reinterpret_cast<const uint4*>(os + sw128(ROWS, qr, h * DH + 8 * k));
      const uint4 k4 = *reinterpret_cast<const uint4*>(kvs + kv_off(rb + lane, h * DH + 8 * k));
      const uint32_t qw[4] = {q4.x, q4.y, q4.z, q4.w}, kw[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 qf = unpack_bf16(qw[i]), kf = unpack_bf16(kw[i]);
        acc = fmaf(qf.x, kf.x, acc);
        acc = fmaf(qf.y, kf.y, acc);
      }
    }
    s = acc;
  }
  float m = s;
#pragma unroll
  for (int i = 16; i > 0; i >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, i));
  const float e = lane < t ? exp2_approx((s - m) * c) : 0.f;
  float sum = e;
#pragma unroll
  for (int i = 16; i > 0; i >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, i);
  const float p = __bfloat162float(__float2bfloat16_rn(e * (1.f / sum)));  // probs in bf16
  float o = 0.f;
  for (int j = 0; j < t; ++j) {
    const float pj = __shfl_sync(0xffffffffu, p, j);
    const __nv_bfloat16 vj =
        *reinterpret_cast<const __nv_bfloat16*>(kvs + kv_off(rb + j, D + h * DH + lane));
    o = fmaf(pj, __bfloat162float(vj), o);
  }
  __syncwarp();  // every lane has read q before o goes over it
  *reinterpret_cast<__nv_bfloat16*>(os + sw128(ROWS, qr, h * DH + lane)) = __float2bfloat16_rn(o);
}

struct Vectors {
  const float* bqkv;  // (384,)
  const float* bo;
  const float* g1;
  const float* be1;
  const float* b1;    // (F,)
  const float* b2;
  const float* g2;
  const float* be2;
};

// The weight maps of one weight set (encoded once, by s3d_fused_encoder_maps).
struct Maps {
  CUtensorMap wqkv, wo, w1, w2;
};

// acc (64 x 128) = rows r0 .. r0 + 63 of the swizzled tile a (a_rows rows)
// times the 128 x 128 stage st^T, as one commit group ...
__device__ __forceinline__ void issue_project(float (&acc)[64], const uint8_t* a, int a_rows,
                                              int r0, const uint8_t* st) {
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss<128, 0, 0>(acc, sw128_desc(a, a_rows, r0, kk), sw128_desc(st, ROWS, 0, kk), kk);
  wgmma_commit();
  reg_fence(acc);
}

// ... and waited for.
__device__ __forceinline__ void project(float (&acc)[64], const uint8_t* a, int a_rows, int r0,
                                        const uint8_t* st) {
  issue_project(acc, a, a_rows, r0, st);
  wgmma_wait<0>();
  reg_fence(acc);
}

// acc + bias (column offset c0 of the vector) rounded to bf16, into KV
// columns c0 - cb .. of this warp's rows
__device__ __forceinline__ void store_kv(uint8_t* kvs, const float (&acc)[64], const float* bias,
                                         int c0, int r0, int wl, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 16 * wl + g + 8 * hh;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + c));
      *reinterpret_cast<uint32_t*>(kvs + kv_off(r, c0 + c)) =
          pack_bf16(acc[4 * j + 2 * hh] + bb.x, acc[4 * j + 2 * hh + 1] + bb.y);
    }
  }
}

__device__ __forceinline__ void add_bias(float (&acc)[64], const float* bias, int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * t4));
    acc[4 * j] += bb.x;
    acc[4 * j + 1] += bb.y;
    acc[4 * j + 2] += bb.x;
    acc[4 * j + 3] += bb.y;
  }
}

// acc += bias + the bf16 row of `res` (global, rows of 128; a null row adds 0)
// for this thread's rows g (res0) and g + 8 (res8)
__device__ __forceinline__ void add_residual(float (&acc)[64], const float* bias,
                                             const __nv_bfloat16* res0,
                                             const __nv_bfloat16* res8, int lane) {
  const int t4 = lane & 3;
  add_bias(acc, bias, lane);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const __nv_bfloat16* res = hh ? res8 : res0;
    if (res == nullptr) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 x = unpack_bf16(*reinterpret_cast<const uint32_t*>(res + 8 * j + 2 * t4));
      acc[4 * j + 2 * hh] += x.x;
      acc[4 * j + 2 * hh + 1] += x.y;
    }
  }
}

// acc += the bf16 rows of the swizzled tile h (h_rows rows) at r0 + 16 wl + g (+ 8)
__device__ __forceinline__ void add_tile_rows(float (&acc)[64], const uint8_t* h, int h_rows,
                                              int r0, int wl, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 16 * wl + g + 8 * hh;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 x =
          unpack_bf16(*reinterpret_cast<const uint32_t*>(h + sw128(h_rows, r, 8 * j + 2 * t4)));
      acc[4 * j + 2 * hh] += x.x;
      acc[4 * j + 2 * hh + 1] += x.y;
    }
  }
}

__device__ __forceinline__ void store_global(__nv_bfloat16* dst, const float (&acc)[64], int hh,
                                             int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) =
        pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
}

constexpr int BAR_BLOCK = 1;  // named barrier of both consumer warpgroups (0: __syncthreads)
constexpr int CONSUMER_THREADS = CONSUMER_WARPS * 32;

// Persistent: block b takes tiles b, b + gridDim.x, ...
template <int HT>
__global__ void __launch_bounds__(WS::THREADS, 1)
    encoder_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tx0,
                   const __grid_constant__ CUtensorMap twqkv,
                   const __grid_constant__ CUtensorMap two, const __grid_constant__ CUtensorMap tw1,
                   const __grid_constant__ CUtensorMap tw2, Vectors vec,
                   const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out, int n,
                   int t, int f, int trim_pts) {
  using L = Layout<HT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Ring<> ring;
  ring.stages = smem;
  ring.full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  ring.empty = ring.full + STAGES;
  uint64_t* xfull = ring.empty + STAGES;
  uint64_t* xempty = xfull + 1;
  uint8_t* xs = smem + L::OFF_X;
  uint8_t* kvs = smem + L::OFF_KV;
  uint8_t* os = smem + L::OFF_O;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pts = ROWS / t;                   // points a packed (sub-)tile
  const int tile_pts = HT ? trim_pts : pts;   // points a tile
  const int subtiles = HT ? (tile_pts + pts - 1) / pts : 1;
  const int n_tiles = (n + tile_pts - 1) / tile_pts;

  if (tid == 0) {
    ring.init();
    mbar_init(xfull, 1);
    mbar_init(xempty, CONSUMER_WARPS);
    mbar_fence_init();
  }
  if constexpr (!HT) {  // the rows past a tile in X and KV stay zero
    for (int i = tid; i < 2 * MAX_T * 8; i += WS::THREADS) {
      const int half = i / (MAX_T * 8), r = ROWS + (i / 8) % MAX_T, c = i % 8;
      *reinterpret_cast<uint4*>(xs + half * L::XR * 128 + r * 128 + c * 16) =
          make_uint4(0, 0, 0, 0);
    }
    for (int i = tid; i < MAX_T * 32; i += WS::THREADS)
      *reinterpret_cast<uint4*>(kvs + (ROWS + i / 32) * 512 + (i % 32) * 16) =
          make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  if (warp >= PRODUCER_WARP) {  // the producer warpgroup: one thread issues every load
    regs_dec<WS::PRODUCER>();
    if (warp == PRODUCER_WARP && lane == 0) {
      int it = 0, xi = 0;
      auto load_x = [&](const CUtensorMap* map, int row) {
        if (xi >= 1) mbar_wait(xempty, (xi - 1) & 1);
        mbar_expect_tx(xfull, ROWS * D * 2);
        tma_load_2d(xs, map, xfull, 0, row);
        tma_load_2d(xs + L::XR * 128, map, xfull, 64, row);
        ++xi;
      };
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        if constexpr (HT) {
          load_x(&tx0, tile * tile_pts);  // token 0 of the tile's points
          ring.load_square(&twqkv, it++, 0);
          ring.load_square(&twqkv, it++, D);
          ring.load_square(&twqkv, it++, 2 * D);
          for (int u = 0; u < subtiles; ++u) load_x(&tx, (tile * tile_pts + u * pts) * t);
        } else {
          load_x(&tx, tile * pts * t);
          ring.load_square(&twqkv, it++, D);      // k
          ring.load_square(&twqkv, it++, 2 * D);  // v
          ring.load_square(&twqkv, it++, 0);      // q
        }
        ring.load_square(&two, it++, 0);
        for (int j = 0; j < f / FT; ++j) ring.load_ffn(&tw1, &tw2, it++, j);
      }
    }
    __syncwarp();
  } else {
    regs_inc<WS::CONSUMER>();
    const int wg = warp >> 2, wl = warp & 3, g = lane >> 2;
    const int r0 = 64 * wg;  // this warpgroup's rows of a tile
    int it = 0, xi = 0;
    float acc[64];
#pragma unroll 1
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      if constexpr (!HT) {
        const int row0 = tile * pts * t;  // the tile's first row of x (N * T rows)
        const int rows_here = min(pts * t, n * t - row0);  // rows stored
        mbar_wait(xfull, xi & 1);
        named_sync(BAR_BLOCK, CONSUMER_THREADS);  // both are past their reads of h1 in KV
        // k, v into KV; q over x in X (this warp's own rows, read by its own
        // warpgroup's products only, which have completed)
#pragma unroll 1
        for (int c = 0; c < 3; ++c, ++it) {
          project(acc, xs, L::XR, r0, ring.acquire(it));
          ring.release(it, lane);
          if (c < 2) {
            store_kv(kvs, acc, vec.bqkv + (c + 1) * D, c * D, r0, wl, lane);
          } else {
            add_bias(acc, vec.bqkv, lane);
            named_sync(2 + wg, 128);  // the warpgroup's products have read x
            store_rows_sw128(xs, L::XR, r0, acc, wl, lane);
          }
        }
        named_sync(BAR_BLOCK, CONSUMER_THREADS);  // q, k, v of every row are in
        {  // items item and item + 8 (point, head) at once
          int item = warp;
          for (; item + CONSUMER_WARPS < pts * NH; item += 2 * CONSUMER_WARPS) {
            const int j = item + CONSUMER_WARPS;
            core_mma<2>(xs, kvs, {(item / NH) * t, (j / NH) * t}, {item % NH, j % NH}, t, lane);
          }
          if (item < pts * NH) core_mma<1>(xs, kvs, {(item / NH) * t}, {item % NH}, t, lane);
        }
        fence_proxy_async();
        named_sync(BAR_BLOCK, CONSUMER_THREADS);  // o of every row is in
        project(acc, xs, L::XR, r0, ring.acquire(it));
        ring.release(it++, lane);
        if (lane == 0) mbar_arrive(xempty);  // x, q and o of this warp's rows are spent
        ++xi;
        {
          const int ra = r0 + 16 * wl + g, rb = ra + 8;
          add_residual(acc, vec.bo, ra < rows_here ? x + size_t(row0 + ra) * D : nullptr,
                       rb < rows_here ? x + size_t(row0 + rb) * D : nullptr, lane);
        }
        layer_norm_rows(acc, vec.g1, vec.be1, lane);
        store_rows_sw128(kvs, ROWS, r0, acc, wl, lane);  // h1 over KV's first 32 KB
        fence_proxy_async();
        named_sync(2 + wg, 128);
        ffn_accumulate(acc, kvs, ROWS, r0, ring, it, vec.b1, f, lane);
        add_bias(acc, vec.b2, lane);
        add_tile_rows(acc, kvs, ROWS, r0, wl, lane);
        layer_norm_rows(acc, vec.g2, vec.be2, lane);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + 16 * wl + g + 8 * hh;
          if (r < rows_here) store_global(out + size_t(row0 + r) * D, acc, hh, lane);
        }
      } else {
        const int pt0 = tile * tile_pts;  // the tile's first point
        const int pts_here = min(tile_pts, n - pt0);
        // q of token 0 -> O
        mbar_wait(xfull, xi & 1);
        project(acc, xs, ROWS, r0, ring.acquire(it));
        ring.release(it++, lane);
        if (lane == 0) mbar_arrive(xempty);
        ++xi;
        add_bias(acc, vec.bqkv, lane);
        named_sync(2 + wg, 128);  // the warpgroup is past the last tile's reads of O
        store_rows_sw128(os, ROWS, r0, acc, wl, lane);
        const uint8_t* wk = ring.acquire(it);
        const uint8_t* wv = ring.acquire(it + 1);
#pragma unroll 1
        for (int u = 0; u < subtiles; ++u) {
          mbar_wait(xfull, xi & 1);
          named_sync(BAR_BLOCK, CONSUMER_THREADS);  // the last sub-tile's core is done
          float acc2[64];  // v's product runs under k's epilogue
          issue_project(acc, xs, ROWS, r0, wk);
          issue_project(acc2, xs, ROWS, r0, wv);
          wgmma_wait<1>();
          reg_fence(acc);
          store_kv(kvs, acc, vec.bqkv + D, 0, r0, wl, lane);
          wgmma_wait<0>();
          reg_fence(acc2);
          if (lane == 0) mbar_arrive(xempty);  // the next sub-tile loads under v's epilogue
          ++xi;
          store_kv(kvs, acc2, vec.bqkv + 2 * D, D, r0, wl, lane);
          named_sync(BAR_BLOCK, CONSUMER_THREADS);  // k, v (and every q) are in
          const int here = min(pts, tile_pts - u * pts);
          for (int item = warp; item < here * NH; item += CONSUMER_WARPS)
            core_one(os, kvs, u * pts + item / NH, (item / NH) * t, item % NH, t, lane);
        }
        ring.release(it++, lane);
        ring.release(it++, lane);
        fence_proxy_async();
        named_sync(BAR_BLOCK, CONSUMER_THREADS);  // o of every point is in
        project(acc, os, ROWS, r0, ring.acquire(it));
        ring.release(it++, lane);
        {
          const int pa = r0 + 16 * wl + g, pb = pa + 8;
          add_residual(acc, vec.bo, pa < pts_here ? x + size_t(pt0 + pa) * t * D : nullptr,
                       pb < pts_here ? x + size_t(pt0 + pb) * t * D : nullptr, lane);
        }
        layer_norm_rows(acc, vec.g1, vec.be1, lane);
        named_sync(2 + wg, 128);  // the warpgroup's products have read o
        store_rows_sw128(os, ROWS, r0, acc, wl, lane);  // h1 over o
        fence_proxy_async();
        named_sync(2 + wg, 128);
        ffn_accumulate(acc, os, ROWS, r0, ring, it, vec.b1, f, lane);
        add_bias(acc, vec.b2, lane);
        add_tile_rows(acc, os, ROWS, r0, wl, lane);
        layer_norm_rows(acc, vec.g2, vec.be2, lane);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = r0 + 16 * wl + g + 8 * hh;
          if (p < pts_here) store_global(out + size_t(pt0 + p) * D, acc, hh, lane);
        }
      }
    }
  }
}

template <int HT>
int launch(const void* x, const Maps& m, const Vectors& vec, void* out, int n, int t, int f,
           cudaStream_t stream) {
  using L = Layout<HT>;
  static DevicePrep prep;
  int grid = 0;
  const int prepared = prepare_on_device(prep, encoder_kernel<HT>, L::SMEM, WS::MIN_LAUNCH, &grid);
  if (prepared != 0) return prepared;
  // every row of x (n t rows), and token 0 of every point (rows t apart)
  CUtensorMap tx, tx0;
  if (encode_sw128(&tx, x, uint64_t(n) * t, D, D * 2, ROWS) ||
      encode_sw128(&tx0, x, uint64_t(n), D, uint64_t(t) * D * 2, ROWS))
    return -2;
  // head_tokens = 1: as few points a tile (at most ROWS) as keep the rounds
  // of blocks that ROWS-point tiles would take, so the last round is full
  const int rounds = ((n + ROWS - 1) / ROWS + grid - 1) / grid;
  const int trim_pts = (n + rounds * grid - 1) / (rounds * grid);
  const int tile_pts = HT ? trim_pts : ROWS / t;
  const int n_tiles = (n + tile_pts - 1) / tile_pts;
  encoder_kernel<HT><<<n_tiles < grid ? n_tiles : grid, WS::THREADS, L::SMEM, stream>>>(
      tx, tx0, m.wqkv, m.wo, m.w1, m.w2, vec, static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(out), n, t, f, trim_pts);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of the weight maps that s3d_fused_encoder_maps writes.
int s3d_fused_encoder_maps_bytes() { return int(sizeof(Maps)); }

// Encode the TMA maps of one weight set (bf16, contiguous: wqkv (384, 128),
// wo (128, 128), w1 (f, 128), w2 (128, f)) into `maps`
// (s3d_fused_encoder_maps_bytes() bytes of host memory).  Returns 0, or -2
// if a map cannot be encoded.
int s3d_fused_encoder_maps(const void* wqkv, const void* wo, const void* w1, const void* w2,
                           int f, void* maps) {
  Maps m;
  if (encode_sw128(&m.wqkv, wqkv, 3 * D, D, D * 2, ROWS) ||
      encode_sw128(&m.wo, wo, D, D, D * 2, ROWS) ||
      encode_sw128(&m.w1, w1, uint64_t(f), D, D * 2, FT) ||
      encode_sw128(&m.w2, w2, D, uint64_t(f), uint64_t(f) * 2, D))
    return -2;
  memcpy(maps, &m, sizeof(Maps));
  return 0;
}

// Blocks of the kernel for the given head_tokens that an SM holds at once.
// Returns 0 or a cudaError_t.
int s3d_fused_encoder_blocks_per_sm(int head_tokens, int* blocks) {
  return head_tokens ? resident_blocks(encoder_kernel<1>, WS::THREADS, Layout<1>::SMEM, blocks)
                     : resident_blocks(encoder_kernel<0>, WS::THREADS, Layout<0>::SMEM, blocks);
}

// x: contiguous bf16 (n, t, 128); out: bf16 (n, t or 1, 128); maps from
// s3d_fused_encoder_maps for this weight set; the vectors fp32.  Returns 0
// on success, the cudaError_t of the launch, -1 for a shape the kernel does
// not take, -2 if a map cannot be encoded, -3 if the kernel was built with
// too few registers for its setmaxnreg, -4 on a device ordinal past
// MAX_DEVICES.  The kernel launches on the host thread's current device.
int s3d_fused_encoder_layer(const void* x, const void* maps, const void* bqkv, const void* bo,
                            const void* g1, const void* be1, const void* b1, const void* b2,
                            const void* g2, const void* be2, void* out, int n, int t, int f,
                            int head_tokens, void* stream) {
  if (n <= 0) return 0;
  if (t < 1 || t > MAX_T || f <= 0 || f % FT || (head_tokens != 0 && head_tokens != 1))
    return -1;
  Maps m;
  memcpy(&m, maps, sizeof(Maps));
  Vectors vec;
  vec.bqkv = static_cast<const float*>(bqkv);
  vec.bo = static_cast<const float*>(bo);
  vec.g1 = static_cast<const float*>(g1);
  vec.be1 = static_cast<const float*>(be1);
  vec.b1 = static_cast<const float*>(b1);
  vec.b2 = static_cast<const float*>(b2);
  vec.g2 = static_cast<const float*>(g2);
  vec.be2 = static_cast<const float*>(be2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_tokens ? launch<1>(x, m, vec, out, n, t, f, s)
                     : launch<0>(x, m, vec, out, n, t, f, s);
}

}  // extern "C"
