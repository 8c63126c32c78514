// Softmax attention over the LDM UNet's flattened feature maps (forward, bf16).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_attention.py::_attention_forward
// (body _attn_kernel).  For every (batch, head) of q, k, v (B, H, T, DH):
//
//   out = softmax(q k^T * scale) v
//
// with the logits and the softmax in fp32 and the products accumulated in fp32.
// The TPU kernel keeps a whole 512 x T fp32 logits block on chip (8 MB at
// T = 4096), normalises it and rounds the probabilities to bf16 before P.V.
// A Hopper block has 227 KB of shared memory, so this kernel streams the keys
// with an online softmax instead: it rounds the unnormalised exp(s - m) to bf16
// for P.V and divides by the fp32 row sum at the end.  The plain version
// (spatial_attention_ref) follows the TPU kernel; the two differ by bf16
// rounding of the probabilities (see chip_smoke.py for the tolerance).
//
// What bounds it: at the UNet's head widths (DH 24 at T 4096, DH 48 at T 1024)
// a key costs 4*DH flops but one exponential per query row, so the special
// function units (16 exp2 per clock per SM) bound it, not the tensor cores
// (4*DH = 96 flops per exp against ~250 bf16 flops per exp the card can do)
// and not memory (q, k, v, o are read/written once: 50 MB at the ds 1 block).
//
// Design (simple and right first; wgmma/TMA and exp emulation are later work):
//   * a block of 4 warps owns 64 query rows of one (batch, head); each warp owns
//     16 rows, kept as bf16 A fragments in registers for the whole key loop;
//   * K/V tiles of 64 keys stream through a double-buffered cp.async ring in
//     static shared memory (25.6 KB at DH 24, 35.8 KB at DH 48);
//   * S = Q K^T on mma.sync m16n8k16 (bf16 in, fp32 accumulate), k padded to a
//     multiple of 16 with zero columns in shared memory (DH 24 -> 32);
//   * running row max and sum in fp32 with log2(e) folded into the scale and
//     one ex2.approx per logit; P's accumulator layout is repacked to bf16 A
//     fragments in registers (no shared-memory round trip) for P.V, whose B
//     fragments come from ldmatrix.trans of the V tile;
//   * the row sums are reduced across the lane quad and divided out at the end;
//     when asked (the autograd path), the row's log-sum-exp in log2 units,
//     L = m + log2(l), is written in fp32 for the backward
//     (csrc/spatial_attention_bwd.cu), which recomputes P = exp2(S c - L).
//
// Only bf16 q/k/v are taken, with T a multiple of 64 and DH 24 or 48 (the UNet's);
// the Python wrapper (slice3d_tpu_torch/ops/spatial_attention.py) raises on
// anything else.  Plain C interface, built with nvcc into a shared library and
// bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = WARPS * 16;  // query rows per block
constexpr int BK = 64;          // keys per K/V tile

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

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy a (rows, DH) bf16 tile from global memory into a (rows, LD) shared tile
// (16-byte chunks; the padding columns are left alone).
template <int DH, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int rows, int tid) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  for (int i = tid; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    cp_async16(dst + r * LD + c, src + size_t(r) * DH + c);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS) attention_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int t, float scale_log2) {
  constexpr int DP = (DH + 15) / 16 * 16;  // k-padded width for Q K^T
  constexpr int LD = DP + 8;                // shared row stride (bank-conflict free)
  constexpr int KS = DP / 16;               // k16 steps of Q K^T
  constexpr int NT = DH / 8;                // n8 tiles of P V
  constexpr int NS = BK / 8;                // n8 tiles of S
  __shared__ __align__(16) __nv_bfloat16 qs[BQ * LD];
  __shared__ __align__(16) __nv_bfloat16 ks[2][BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[2][BK * LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_qblocks = t / BQ;
  const int bh = blockIdx.x / n_qblocks;
  const int q0 = (blockIdx.x % n_qblocks) * BQ;
  const __nv_bfloat16* qg = q + (size_t(bh) * t + q0) * DH;
  const __nv_bfloat16* kg = k + size_t(bh) * t * DH;
  const __nv_bfloat16* vg = v + size_t(bh) * t * DH;

  // zero the padding columns once (cp.async never writes them; BQ == BK)
  for (int r = tid; r < BQ; r += THREADS) {
    for (int c = DH; c < LD; ++c) {
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      qs[r * LD + c] = zero;
      ks[0][r * LD + c] = zero;
      ks[1][r * LD + c] = zero;
      vs[0][r * LD + c] = zero;
      vs[1][r * LD + c] = zero;
    }
  }
  load_tile<DH, LD>(qs, qg, BQ, tid);
  load_tile<DH, LD>(ks[0], kg, BK, tid);
  load_tile<DH, LD>(vs[0], vg, BK, tid);
  cp_async_commit();
  const int n_tiles = t / BK;
  if (n_tiles > 1) {
    load_tile<DH, LD>(ks[1], kg + size_t(BK) * DH, BK, tid);
    load_tile<DH, LD>(vs[1], vg + size_t(BK) * DH, BK, tid);
  }
  cp_async_commit();

  uint32_t qa[KS][4];
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8 (log2 units)
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

  // B-fragment addressing: non-transposed (K as the n-major operand) and
  // transposed (V as the k-major operand)
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 8;

#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      const __nv_bfloat16* p = qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldsm_x4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                                              p + 16 * kk);
    }
    const __nv_bfloat16* kt = ks[it & 1];
    const __nv_bfloat16* vt = vs[it & 1];

    // S (16 x 64) = Q K^T, fp32
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3, kt + (16 * j + brow) * LD + 16 * kk + bcol);
        mma(s[2 * j], qa[kk], b0, b1);
        mma(s[2 * j + 1], qa[kk], b2, b3);
      }
    }

    // online softmax, rows g (half 0) and g + 8 (half 1)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * half] *= scale_log2;
        s[j][2 * half + 1] *= scale_log2;
        mx = fmaxf(mx, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      const float alpha = exp2_approx(m_run[half] - m_new);
      m_run[half] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * half] = exp2_approx(s[j][2 * half] - m_new);
        s[j][2 * half + 1] = exp2_approx(s[j][2 * half + 1] - m_new);
        sum += s[j][2 * half] + s[j][2 * half + 1];
      }
      l_run[half] = l_run[half] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][2 * half] *= alpha;
        o[j][2 * half + 1] *= alpha;
      }
    }

    // O (16 x DH) += P V: P's accumulator layout is the A layout (k = keys)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jj = 0; jj < (NT + 1) / 2; ++jj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3, vt + (16 * kk + vrow) * LD + 16 * jj + vcol);
        mma(o[2 * jj], pa, b0, b1);
        if (2 * jj + 1 < NT) mma(o[2 * jj + 1], pa, b2, b3);
      }
    }

    __syncthreads();  // everyone is done with this stage
    if (it + 2 < n_tiles) {
      load_tile<DH, LD>(ks[it & 1], kg + size_t(it + 2) * BK * DH, BK, tid);
      load_tile<DH, LD>(vs[it & 1], vg + size_t(it + 2) * BK * DH, BK, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  // divide by the row sums and write bf16
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_run[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = q0 + warp * 16 + g + 8 * half;
    if (lse != nullptr && t4 == 0) lse[size_t(bh) * t + row] = m_run[half] + log2f(l);
    __nv_bfloat16* dst = out + (size_t(bh) * t + row) * DH;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) =
          pack_bf16(o[j][2 * half] * inv, o[j][2 * half + 1] * inv);
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
           int t, float scale, cudaStream_t stream) {
  const float log2e = 1.4426950408889634f;
  const dim3 grid(unsigned(bh) * unsigned(t / BQ));
  attention_fwd_kernel<DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse,
      t, scale * log2e);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, out: contiguous bf16 (bh, t, dh); lse: fp32 (bh, t) or null (the
// rows' log-sum-exp of S * scale in log2 units, written only when given).
// Returns 0 on success, the cudaError_t of the launch, or -1 for a shape the
// kernel does not take.
int s3d_spatial_attention(const void* q, const void* k, const void* v, void* out, void* lse,
                          int bh, int t, int dh, float scale, void* stream) {
  if (bh <= 0 || t <= 0 || t % BQ != 0 || t % BK != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 24: return launch<24>(q, k, v, out, static_cast<float*>(lse), bh, t, scale, s);
    case 48: return launch<48>(q, k, v, out, static_cast<float*>(lse), bh, t, scale, s);
    default: return -1;
  }
}

}  // extern "C"
