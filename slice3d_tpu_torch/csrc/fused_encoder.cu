// Fused post-LN transformer encoder layer for the SDF head (inference, bf16).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_encoder.py::fused_encoder_layer
// (kernel bodies _layer_kernel_bdq, _layer_kernel_v2, _layer_kernel_grouped and
// the per-head _layer_kernel, which all compute the same layer).  For every
// query point, over its T <= 16 tokens of width 128:
//
//   qkv  = x Wqkv^T + bqkv                        -> bf16
//   per head h (4 heads of 32): softmax(q_h k_h^T / sqrt(32), pad keys -1e9)
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
// What bounds it: a full layer is ~15.4 MFLOP per point (88% of it the
// 128 -> 2048 -> 128 FFN) against ~6.7 KB of activations in and out, far
// above the card's ~295 FLOP/byte balance point, so it is compute-bound on the
// tensor cores.  The weights (1.2 MB bf16) do not fit in shared memory.
//
// Design (simple and right first; wgmma/TMA/persistent blocks are later work):
//   * a block of 8 warps owns 128 rows: with head_tokens = 0 each warp owns one
//     point (its 16 padded tokens are exactly one m16 tile); with
//     head_tokens = 1 each warp runs attention for 16 points one after another
//     and keeps token 0 of each, so the FFN still sees full m16 tiles;
//   * the attention weights (Wqkv, Wo: 136 KB padded) are staged in shared
//     memory once per block; attention runs per warp on mma.sync m16n8k16
//     (bf16 in, fp32 accumulate), q and the probabilities stay in registers;
//   * the FFN streams W1/W2 in 64-wide F-tiles through a double-buffered
//     cp.async ring in the same shared memory, so each weight byte fetched
//     from L2 serves 128 rows, and the (rows, 2048) activation lives only in
//     registers (the accumulator layout of one mma is the A layout of the next):
//     the F-tile loop of csrc/ffn_tile.cuh, shared with csrc/fused_ffn.cu.
//
// Only bf16 activations are taken: an fp32 input has no instantiation here and
// the Python wrapper raises for it.
//
// Plain C interface, built with nvcc into a shared library and bound with
// ctypes (slice3d_tpu_torch/ops/fused_encoder.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ffn_tile.cuh"

namespace {

using namespace s3d;  // D, FT, LDW, STAGE, the mma/ldmatrix/cp.async helpers

constexpr int NH = 4;             // heads
constexpr int DH = 32;            // head width
constexpr int TP = 16;            // padded tokens per point (one m16 tile)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 16;  // FFN rows per block

constexpr int LDKV = DH + 8;      // padded row of a per-warp k/v tile

// shared memory layout, in bf16 elements
constexpr int SM_WQKV = 0;                          // (384, LDW)
constexpr int SM_WO = SM_WQKV + 3 * D * LDW;        // (128, LDW)
constexpr int SM_WEND = SM_WO + D * LDW;            // end of the weight area
constexpr int SM_X = SM_WEND;                       // (WARPS, 16, LDW)
constexpr int SM_KV = SM_X + WARPS * TP * LDW;      // (WARPS, 2, 16, LDKV)
constexpr int SM_H1 = SM_KV + WARPS * 2 * TP * LDKV;  // (ROWS, LDW)
constexpr int SM_TOTAL = SM_H1 + ROWS * LDW;
constexpr size_t SMEM_BYTES = size_t(SM_TOTAL) * 2;
static_assert(2 * STAGE <= SM_WEND, "FFN ring must fit in the weight area");
static_assert(SMEM_BYTES <= 232448, "shared memory over the per-block limit");

// acc (16 x 32, four n8 tiles) += A (16 x 128) * W[n0:n0+32, :]^T, W row-major (., LDW)
__device__ __forceinline__ void gemm_n32(float (*acc)[4], const uint32_t (*a)[4],
                                         const __nv_bfloat16* w, int n0, int lane) {
  const int row = (lane & 7) + ((lane >> 4) << 3);
  const int col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b0, b1, b2, b3, w + (n0 + 16 * j + row) * LDW + 16 * k + col);
      mma(acc[2 * j], a[k], b0, b1);
      mma(acc[2 * j + 1], a[k], b2, b3);
    }
  }
}

// Row statistics of a 16 x 128 fp32 tile in the accumulator layout: each
// thread holds rows g and g + 8, 32 values each; a row spans a lane quad.
__device__ __forceinline__ void layer_norm_rows(float (*v)[4], const float* gamma,
                                                const float* beta, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) s += v[j][2 * half] + v[j][2 * half + 1];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mu = s * (1.f / D);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float d0 = v[j][2 * half] - mu, d1 = v[j][2 * half + 1] - mu;
      q += d0 * d0 + d1 * d1;
    }
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    const float rs = rsqrtf(q * (1.f / D) + 1e-5f);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t;
      v[j][2 * half] = (v[j][2 * half] - mu) * rs * __ldg(gamma + c) + __ldg(beta + c);
      v[j][2 * half + 1] =
          (v[j][2 * half + 1] - mu) * rs * __ldg(gamma + c + 1) + __ldg(beta + c + 1);
    }
  }
}

struct Params {
  const __nv_bfloat16* x;     // (N, T, 128)
  const __nv_bfloat16* wqkv;  // (384, 128)  in_proj_weight
  const float* bqkv;          // (384,)
  const __nv_bfloat16* wo;    // (128, 128)  out_proj.weight
  const float* bo;
  const float* g1;
  const float* be1;
  const __nv_bfloat16* w1;    // (F, 128)    linear1.weight
  const float* b1;            // (F,)
  const __nv_bfloat16* w2;    // (128, F)    linear2.weight
  const float* b2;
  const float* g2;
  const float* be2;
  __nv_bfloat16* out;         // (N, T or 1, 128)
  int n, t, f, head_tokens;
};

__global__ void __launch_bounds__(THREADS, 1) encoder_layer_kernel(Params p) {
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int pts_per_warp = p.head_tokens ? TP : 1;
  const int pt_base = blockIdx.x * WARPS * pts_per_warp + warp * pts_per_warp;

  __nv_bfloat16* ws = sm + SM_WQKV;
  __nv_bfloat16* wos = sm + SM_WO;
  __nv_bfloat16* xs = sm + SM_X + warp * TP * LDW;
  __nv_bfloat16* ks = sm + SM_KV + warp * 2 * TP * LDKV;
  __nv_bfloat16* vs = ks + TP * LDKV;
  __nv_bfloat16* h1s = sm + SM_H1;

  // attention weights -> shared memory (one group)
  for (int i = tid; i < 3 * D * 16; i += THREADS) {
    const int r = i >> 4, c = (i & 15) * 8;
    cp_async16(ws + r * LDW + c, p.wqkv + size_t(r) * D + c);
  }
  for (int i = tid; i < D * 16; i += THREADS) {
    const int r = i >> 4, c = (i & 15) * 8;
    cp_async16(wos + r * LDW + c, p.wo + size_t(r) * D + c);
  }
  cp_async_commit();
  // padded token rows stay zero
  for (int i = p.t * 16 + lane; i < TP * 16; i += 32) {
    *reinterpret_cast<uint4*>(xs + (i >> 4) * LDW + (i & 15) * 8) = make_uint4(0, 0, 0, 0);
  }

  const float scale = rsqrtf(float(DH));
  for (int pi = 0; pi < pts_per_warp; ++pi) {
    // clamp past-the-end points to the last one; their rows are never stored
    const int pt = min(pt_base + pi, p.n - 1);
    const __nv_bfloat16* xg = p.x + size_t(pt) * p.t * D;
    __syncwarp();
    for (int i = lane; i < p.t * 16; i += 32) {
      cp_async16(xs + (i >> 4) * LDW + (i & 15) * 8, xg + i * 8);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    if (pi == 0) __syncthreads();  // the attention weights are in

    uint32_t xa[D / 16][4];
    load_a128(xa, xs, lane);

    float attn[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) attn[j][0] = attn[j][1] = attn[j][2] = attn[j][3] = 0.f;

#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      // k_h, v_h -> per-warp shared tiles (bf16, bias added in fp32)
#pragma unroll
      for (int kv = 1; kv < 3; ++kv) {
        float acc[4][4] = {};
        gemm_n32(acc, xa, ws, kv * D + h * DH, lane);
        __nv_bfloat16* dst = kv == 1 ? ks : vs;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * j + 2 * t4;
          const float bb0 = __ldg(p.bqkv + kv * D + h * DH + c);
          const float bb1 = __ldg(p.bqkv + kv * D + h * DH + c + 1);
          *reinterpret_cast<uint32_t*>(dst + g * LDKV + c) =
              pack_bf16(acc[j][0] + bb0, acc[j][1] + bb1);
          *reinterpret_cast<uint32_t*>(dst + (g + 8) * LDKV + c) =
              pack_bf16(acc[j][2] + bb0, acc[j][3] + bb1);
        }
      }
      // q_h stays in registers as the A operand of the logits
      uint32_t qa[2][4];
      {
        float acc[4][4] = {};
        gemm_n32(acc, xa, ws, h * DH, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * j + 2 * t4;
          const float bb0 = __ldg(p.bqkv + h * DH + c);
          const float bb1 = __ldg(p.bqkv + h * DH + c + 1);
          qa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(acc[j][0] + bb0, acc[j][1] + bb1);
          qa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(acc[j][2] + bb0, acc[j][3] + bb1);
        }
      }
      __syncwarp();

      // logits (16 x 16) = q_h k_h^T
      float s[2][4] = {};
      {
        const int row = (lane & 7) + ((lane >> 4) << 3);
        const int col = ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(b0, b1, b2, b3, ks + row * LDKV + 16 * k + col);
          mma(s[0], qa[k], b0, b1);
          mma(s[1], qa[k], b2, b3);
        }
      }
      // fp32 softmax over the key axis; pad keys get -1e9
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t4 + e;
            v[2 * j + e] = s[j][2 * half + e] * scale + (col >= p.t ? -1e9f : 0.f);
          }
        }
        float m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = expf(v[i] - m);
          sum += v[i];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        // A layout: a0/a2 = row g (tiles 0/1), a1/a3 = row g + 8
        pa[half] = pack_bf16(v[0] / sum, v[1] / sum);
        pa[half + 2] = pack_bf16(v[2] / sum, v[3] / sum);
      }

      // o_h (16 x 32) = probs v_h, rounded to bf16 as the out-proj A operand
      uint32_t oa[2][4];
      {
        float o[4][4] = {};
        const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(b0, b1, b2, b3, vs + row * LDKV + 16 * j + col);
          mma(o[2 * j], pa, b0, b1);
          mma(o[2 * j + 1], pa, b2, b3);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          oa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(o[j][0], o[j][1]);
          oa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(o[j][2], o[j][3]);
        }
      }
      // attn (16 x 128) += o_h Wo[:, h*32:(h+1)*32]^T
      {
        const int row = (lane & 7) + ((lane >> 4) << 3);
        const int col = ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4(b0, b1, b2, b3, wos + (16 * j + row) * LDW + h * DH + 16 * k + col);
            mma(attn[2 * j], oa[k], b0, b1);
            mma(attn[2 * j + 1], oa[k], b2, b3);
          }
        }
      }
      __syncwarp();  // k/v tiles are rewritten by the next head
    }

    // h1 = LN1(x + attn + bo), rounded to bf16
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t4;
      const float bb0 = __ldg(p.bo + c), bb1 = __ldg(p.bo + c + 1);
      const float2 x0 = unpack_bf16(*reinterpret_cast<const uint32_t*>(xs + g * LDW + c));
      const float2 x1 =
          unpack_bf16(*reinterpret_cast<const uint32_t*>(xs + (g + 8) * LDW + c));
      attn[j][0] += bb0 + x0.x;
      attn[j][1] += bb1 + x0.y;
      attn[j][2] += bb0 + x1.x;
      attn[j][3] += bb1 + x1.y;
    }
    layer_norm_rows(attn, p.g1, p.be1, lane);
    if (p.head_tokens) {
      if (g == 0) {  // token 0 of this point -> FFN row warp*16 + pi
        __nv_bfloat16* dst = h1s + (warp * TP + pi) * LDW;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) =
              pack_bf16(attn[j][0], attn[j][1]);
        }
      }
    } else {
      __nv_bfloat16* dst = h1s + warp * TP * LDW;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * t4;
        *reinterpret_cast<uint32_t*>(dst + g * LDW + c) = pack_bf16(attn[j][0], attn[j][1]);
        *reinterpret_cast<uint32_t*>(dst + (g + 8) * LDW + c) =
            pack_bf16(attn[j][2], attn[j][3]);
      }
    }
  }
  __syncthreads();  // attention weights are dead; the FFN ring reuses them

  // ---- FFN: out = h1 W1^T -> relu -> W2^T, streamed over F-tiles -----------
  uint32_t ha[D / 16][4];
  load_a128(ha, h1s + warp * TP * LDW, lane);

  float out[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) out[j][0] = out[j][1] = out[j][2] = out[j][3] = 0.f;
  ffn_accumulate<THREADS>(out, ha, sm, p.w1, p.b1, p.w2, p.f, tid, lane);

  // out = LN2(h1 + ff + b2)
  const __nv_bfloat16* hrow = h1s + warp * TP * LDW;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t4;
    const float bb0 = __ldg(p.b2 + c), bb1 = __ldg(p.b2 + c + 1);
    const float2 h0 = unpack_bf16(*reinterpret_cast<const uint32_t*>(hrow + g * LDW + c));
    const float2 h8 =
        unpack_bf16(*reinterpret_cast<const uint32_t*>(hrow + (g + 8) * LDW + c));
    out[j][0] += bb0 + h0.x;
    out[j][1] += bb1 + h0.y;
    out[j][2] += bb0 + h8.x;
    out[j][3] += bb1 + h8.y;
  }
  layer_norm_rows(out, p.g2, p.be2, lane);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half;  // row of this warp's m16 tile
    __nv_bfloat16* dst;
    if (p.head_tokens) {
      const int pt = pt_base + r;
      if (pt >= p.n) continue;
      dst = p.out + size_t(pt) * D;
    } else {
      if (pt_base >= p.n || r >= p.t) continue;
      dst = p.out + (size_t(pt_base) * p.t + r) * D;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) =
          pack_bf16(out[j][2 * half], out[j][2 * half + 1]);
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success or the cudaError_t of the launch.
int s3d_fused_encoder_layer(const void* x, const void* wqkv, const void* bqkv,
                            const void* wo, const void* bo, const void* g1,
                            const void* be1, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* g2,
                            const void* be2, void* out, int n, int t, int f,
                            int head_tokens, void* stream) {
  if (n <= 0) return 0;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wqkv = static_cast<const __nv_bfloat16*>(wqkv);
  p.bqkv = static_cast<const float*>(bqkv);
  p.wo = static_cast<const __nv_bfloat16*>(wo);
  p.bo = static_cast<const float*>(bo);
  p.g1 = static_cast<const float*>(g1);
  p.be1 = static_cast<const float*>(be1);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const __nv_bfloat16*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.g2 = static_cast<const float*>(g2);
  p.be2 = static_cast<const float*>(be2);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.n = n;
  p.t = t;
  p.f = f;
  p.head_tokens = head_tokens;
  cudaError_t err = cudaFuncSetAttribute(
      encoder_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const int per_block = WARPS * (head_tokens ? TP : 1);
  const int blocks = (n + per_block - 1) / per_block;
  encoder_layer_kernel<<<blocks, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

}  // extern "C"
