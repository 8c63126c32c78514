// Softmax attention over the LDM UNet's flattened feature maps: backward (bf16).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_attention.py::_attention_backward
// (body _attn_bwd_kernel).  For every (batch, head), from q, k, v, the forward's
// output o and the row log-sum-exp L it saved (csrc/spatial_attention.cu), and
// the output's gradient do, all (B, H, T, DH):
//
//   P  = softmax(q k^T * scale)              recomputed, P = exp2(S c - L)
//   dP = do v^T                                fp32
//   dS = P * (dP - D) * scale, D = rowsum(do * o), rounded to bf16
//   dq = dS k,  dk = dS^T q,  dv = P(bf16)^T do   fp32 accumulation, bf16 out
//
// The TPU kernel holds a 128 x T block of fp32 P, dP and dS in VMEM (6 MB at
// T = 4096) and sums rowsum(dP * P); a Hopper block has 227 KB of shared
// memory.  This one streams 64-row tiles and never forms anything (T, T)-shaped:
// D = rowsum(do * o), equal to rowsum(dP * P) in exact arithmetic, comes from
// a small pre-pass, and the saved L gives P without a second softmax.  o is
// bf16, so D differs from the TPU kernel's by o's rounding; the plain version
// (spatial_attention_bwd_ref) follows the TPU kernel and chip_smoke.py states
// the tolerance between them.
//
// What bounds it: 10 * T^2 * DH flops on the tensor cores per (batch, head)
// and one exponential per logit on the special function units (16 exp2 per
// clock per SM).  At the UNet's head widths (DH 24 at T 4096, DH 48 at T 1024)
// the two take about as long; the bytes (q, k, v, o, do read, dq, dk, dv
// written once: 0.1 GB at the ds 1 block) are an order of magnitude less.
//
// Design (simple and right first; wgmma/TMA and a single pass with atomics are
// later work).  Three kernels on the caller's stream:
//   * delta: D = rowsum(do * o) in fp32, one thread per row;
//   * dk/dv: a block of 4 warps owns 64 keys of one (batch, head), each warp 16
//     keys, kept as bf16 A fragments of K and V in registers; the 64-query tiles
//     of Q, dO, L and D stream through a double-buffered cp.async ring in
//     static shared memory.  Per tile, S^T = K Q^T and dP^T = V dO^T on
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate; DH 24 padded to 32 with zero
//     columns in shared memory), P^T and dS^T in registers, repacked as bf16 A
//     fragments for dV += P^T dO and dK += dS^T Q, whose B fragments come from
//     ldmatrix.trans of the dO and Q tiles;
//   * dq: a block owns 64 queries (Q, dO as A fragments, L and D per row in
//     registers) and streams 64-key tiles of K and V: S = Q K^T, dP = dO V^T,
//     dS, then dQ += dS K with K's B fragments from ldmatrix.trans.
// The two passes recompute S and dP each (7 products instead of 5, and two
// exponentials per logit) so that no block adds into another's output: no
// atomics, and the result does not depend on the order the blocks run in.
//
// Only bf16 with T a multiple of 64 and DH 24 or 48 (the UNet's) is taken; the
// Python wrapper (slice3d_tpu_torch/ops/spatial_attention.py) raises on
// anything else.  Plain C interface, built with nvcc into a shared library and
// bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BT = WARPS * 16;  // rows per block (keys or queries) and per tile

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

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy a (BT, DH) bf16 tile from global memory into a (BT, LD) shared tile
// (16-byte chunks; the padding columns are left alone).
template <int DH, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int tid) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  for (int i = tid; i < BT * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    cp_async16(dst + r * LD + c, src + size_t(r) * DH + c);
  }
}

// Copy BT fp32 values (16 chunks of 16 bytes).
__device__ __forceinline__ void load_row_values(float* dst, const float* src, int tid) {
  if (tid < BT / 4) cp_async16(dst + 4 * tid, src + 4 * tid);
}

// Zero the padding columns DH .. LD-1 of a (BT, LD) shared tile.
template <int DH, int LD>
__device__ __forceinline__ void zero_pad(__nv_bfloat16* tile, int tid) {
  for (int i = tid; i < BT * (LD - DH); i += THREADS) {
    tile[(i / (LD - DH)) * LD + DH + i % (LD - DH)] = __float2bfloat16(0.f);
  }
}

// A fragments (16 rows x DP) of a warp's 16 rows of a (BT, LD) shared tile.
template <int KS, int LD>
__device__ __forceinline__ void load_a(uint32_t (*a)[4], const __nv_bfloat16* tile,
                                       int warp, int lane) {
  const __nv_bfloat16* p = tile + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_x4(a[kk], p + 16 * kk);
}

// acc (16 x 64, fp32) = A (16 x DP) times the (64, LD) tile's rows transposed:
// the tile's rows are the n dimension (non-transposed ldmatrix).
template <int KS, int LD>
__device__ __forceinline__ void mma_rows(float (*acc)[4], const uint32_t (*a)[4],
                                         const __nv_bfloat16* tile, int lane) {
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int j = 0; j < BT / 16; ++j) {
      uint32_t b[4];
      ldsm_x4(b, tile + (16 * j + brow) * LD + 16 * kk + bcol);
      mma(acc[2 * j], a[kk], b[0], b[1]);
      mma(acc[2 * j + 1], a[kk], b[2], b[3]);
    }
  }
}

// out (16 x DH, fp32) += X (16 x 64, the accumulators x rounded to bf16 A
// fragments) times the (64, LD) tile: the tile's rows are the k dimension
// (transposed ldmatrix).
template <int NT, int LD>
__device__ __forceinline__ void mma_cols(float (*out)[4], const float (*x)[4],
                                         const __nv_bfloat16* tile, int lane) {
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int jj = 0; jj < (NT + 1) / 2; ++jj) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + (16 * kk + vrow) * LD + 16 * jj + vcol);
      mma(out[2 * jj], a, b[0], b[1]);
      if (2 * jj + 1 < NT) mma(out[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// Write a warp's 16 x DH fp32 accumulators as bf16 rows starting at row0.
template <int NT, int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (*acc)[4],
                                           int row0, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    __nv_bfloat16* p = dst + size_t(row0 + g + 8 * half) * DH;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<uint32_t*>(p + 8 * j + 2 * t4) =
          pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// D = rowsum(do * o) in fp32, one thread per row.
template <int DH>
__global__ void attention_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                                           const __nv_bfloat16* __restrict__ dout,
                                           float* __restrict__ delta, int rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(o + size_t(r) * DH);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(dout + size_t(r) * DH);
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH / 2; ++d) {
    const float2 x = __bfloat1622float2(a[d]), y = __bfloat1622float2(b[d]);
    s += x.x * y.x + x.y * y.y;
  }
  delta[r] = s;
}

// dk, dv for 64 keys of one (batch, head) per block.
template <int DH>
__global__ void __launch_bounds__(THREADS) attention_bwd_dkdv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int t, float scale,
    float scale_log2) {
  constexpr int DP = (DH + 15) / 16 * 16;  // k-padded width of the head dim
  constexpr int LD = DP + 8;                // shared row stride (bank-conflict free)
  constexpr int KS = DP / 16;
  constexpr int NT = DH / 8;
  constexpr int NS = BT / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[BT * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BT * LD];
  __shared__ __align__(16) __nv_bfloat16 qs[2][BT * LD];
  __shared__ __align__(16) __nv_bfloat16 dos[2][BT * LD];
  __shared__ __align__(16) float ls[2][BT];
  __shared__ __align__(16) float dls[2][BT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int n_blocks = t / BT;
  const int bh = blockIdx.x / n_blocks;
  const int k0 = (blockIdx.x % n_blocks) * BT;
  const size_t base = size_t(bh) * t;
  const __nv_bfloat16* qg = q + base * DH;
  const __nv_bfloat16* dog = dout + base * DH;
  const float* lg = lse + base;
  const float* dg = delta + base;

  zero_pad<DH, LD>(ks, tid);
  zero_pad<DH, LD>(vs, tid);
  zero_pad<DH, LD>(qs[0], tid);
  zero_pad<DH, LD>(qs[1], tid);
  zero_pad<DH, LD>(dos[0], tid);
  zero_pad<DH, LD>(dos[1], tid);
  load_tile<DH, LD>(ks, k + (base + k0) * DH, tid);
  load_tile<DH, LD>(vs, v + (base + k0) * DH, tid);
  const int n_tiles = t / BT;
  for (int s = 0; s < 2; ++s) {
    if (s < n_tiles) {
      load_tile<DH, LD>(qs[s], qg + size_t(s) * BT * DH, tid);
      load_tile<DH, LD>(dos[s], dog + size_t(s) * BT * DH, tid);
      load_row_values(ls[s], lg + s * BT, tid);
      load_row_values(dls[s], dg + s * BT, tid);
    }
    cp_async_commit();
  }

  uint32_t ka[KS][4], va[KS][4];
  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      load_a<KS, LD>(ka, ks, warp, lane);
      load_a<KS, LD>(va, vs, warp, lane);
    }
    const __nv_bfloat16* qt = qs[it & 1];
    const __nv_bfloat16* dt = dos[it & 1];
    const float* lt = ls[it & 1];
    const float* dlt = dls[it & 1];

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x the tile's 64 queries
    float s[NS][4], dp[NS][4];
    mma_rows<KS, LD>(s, ka, qt, lane);
    mma_rows<KS, LD>(dp, va, dt, lane);

    // P^T = exp2(S^T c - L) and dS^T = P^T (dP^T - D) scale; accumulator
    // element 2 half + e is key g + 8 half, query 8 j + 2 t4 + e
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = lt[8 * j + 2 * t4 + e], d = dlt[8 * j + 2 * t4 + e];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 2 * half + e;
          const float p = exp2_approx(s[j][i] * scale_log2 - l);
          s[j][i] = p;
          dp[j][i] = p * (dp[j][i] - d) * scale;
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's queries
    mma_cols<NT, LD>(dv_acc, s, dt, lane);
    mma_cols<NT, LD>(dk_acc, dp, qt, lane);

    __syncthreads();  // everyone is done with this stage
    if (it + 2 < n_tiles) {
      const int s2 = it + 2;
      load_tile<DH, LD>(qs[it & 1], qg + size_t(s2) * BT * DH, tid);
      load_tile<DH, LD>(dos[it & 1], dog + size_t(s2) * BT * DH, tid);
      load_row_values(ls[it & 1], lg + s2 * BT, tid);
      load_row_values(dls[it & 1], dg + s2 * BT, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  const int row0 = k0 + warp * 16;
  store_rows<NT, DH>(dk + base * DH, dk_acc, row0, lane);
  store_rows<NT, DH>(dv + base * DH, dv_acc, row0, lane);
}

// dq for 64 queries of one (batch, head) per block.
template <int DH>
__global__ void __launch_bounds__(THREADS) attention_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int t, float scale, float scale_log2) {
  constexpr int DP = (DH + 15) / 16 * 16;
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;
  constexpr int NT = DH / 8;
  constexpr int NS = BT / 8;
  __shared__ __align__(16) __nv_bfloat16 qs[BT * LD];
  __shared__ __align__(16) __nv_bfloat16 dos[BT * LD];
  __shared__ __align__(16) __nv_bfloat16 ks[2][BT * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[2][BT * LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int n_blocks = t / BT;
  const int bh = blockIdx.x / n_blocks;
  const int q0 = (blockIdx.x % n_blocks) * BT;
  const size_t base = size_t(bh) * t;
  const __nv_bfloat16* kg = k + base * DH;
  const __nv_bfloat16* vg = v + base * DH;

  zero_pad<DH, LD>(qs, tid);
  zero_pad<DH, LD>(dos, tid);
  zero_pad<DH, LD>(ks[0], tid);
  zero_pad<DH, LD>(ks[1], tid);
  zero_pad<DH, LD>(vs[0], tid);
  zero_pad<DH, LD>(vs[1], tid);
  load_tile<DH, LD>(qs, q + (base + q0) * DH, tid);
  load_tile<DH, LD>(dos, dout + (base + q0) * DH, tid);
  const int n_tiles = t / BT;
  for (int s = 0; s < 2; ++s) {
    if (s < n_tiles) {
      load_tile<DH, LD>(ks[s], kg + size_t(s) * BT * DH, tid);
      load_tile<DH, LD>(vs[s], vg + size_t(s) * BT * DH, tid);
    }
    cp_async_commit();
  }

  // this thread's rows: q0 + 16 warp + g (half 0) and + 8 (half 1)
  float l_row[2], d_row[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const size_t row = base + q0 + warp * 16 + g + 8 * half;
    l_row[half] = lse[row];
    d_row[half] = delta[row];
  }

  uint32_t qa[KS][4], doa[KS][4];
  float dq_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      load_a<KS, LD>(qa, qs, warp, lane);
      load_a<KS, LD>(doa, dos, warp, lane);
    }
    const __nv_bfloat16* kt = ks[it & 1];
    const __nv_bfloat16* vt = vs[it & 1];

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x the tile's 64 keys
    float s[NS][4], dp[NS][4];
    mma_rows<KS, LD>(s, qa, kt, lane);
    mma_rows<KS, LD>(dp, doa, vt, lane);

    // dS = P (dP - D) scale; accumulator element 2 half + e is query g + 8 half
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int half = i >> 1;
        const float p = exp2_approx(s[j][i] * scale_log2 - l_row[half]);
        dp[j][i] = p * (dp[j][i] - d_row[half]) * scale;
      }
    }

    // dQ += dS K over the tile's keys
    mma_cols<NT, LD>(dq_acc, dp, kt, lane);

    __syncthreads();
    if (it + 2 < n_tiles) {
      load_tile<DH, LD>(ks[it & 1], kg + size_t(it + 2) * BT * DH, tid);
      load_tile<DH, LD>(vs[it & 1], vg + size_t(it + 2) * BT * DH, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  store_rows<NT, DH>(dq + base * DH, dq_acc, q0 + warp * 16, lane);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int bh, int t,
           float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const float scale_log2 = scale * 1.4426950408889634f;
  const int rows = bh * t;
  attention_bwd_delta_kernel<DH><<<(rows + 255) / 256, 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned(bh) * unsigned(t / BT));
  attention_bwd_dkdv_kernel<DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), t, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  attention_bwd_dq_kernel<DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), t, scale,
      scale_log2);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o (the forward's output), dout, dq, dk, dv: contiguous bf16
// (bh, t, dh); lse: the forward's fp32 (bh, t) row log-sum-exp (log2 units);
// delta: fp32 (bh, t) scratch.  Returns 0 on success, the cudaError_t of a
// launch, or -1 for a shape the kernels do not take.
int s3d_spatial_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int bh, int t, int dh, float scale,
                              void* stream) {
  if (bh <= 0 || t <= 0 || t % BT != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (dh) {
    case 24: return launch<24>(q, k, v, o, dout, l, d, dq, dk, dv, bh, t, scale, s);
    case 48: return launch<48>(q, k, v, o, dout, l, d, dq, dk, dv, bh, t, scale, s);
    default: return -1;
  }
}

}  // extern "C"
