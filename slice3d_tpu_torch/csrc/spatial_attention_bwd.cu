// Softmax attention over the LDM UNet's flattened feature maps: backward (bf16).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_attention.py::_attention_backward
// (pallas_call at :150, body _attn_bwd_kernel).  For every (batch, head), from
// q, k, v, the forward's output o and the row log-sum-exp L it saved
// (csrc/spatial_attention.cu), and the output's gradient do, all (B, H, T, DH):
//
//   P  = softmax(q k^T * scale)              recomputed, P = exp2(S c - L)
//   dP = do v^T                                fp32
//   dS = P * (dP - D) * scale, D = rowsum(do * o), rounded to bf16
//   dq = dS k,  dk = dS^T q,  dv = P(bf16)^T do   fp32 accumulation, bf16 out
//
// The TPU kernel holds a 128 x T block of fp32 P, dP and dS in VMEM (6 MB at
// T = 4096) and sums rowsum(dP * P); a Hopper block has 227 KB of shared
// memory.  This one streams 64-query tiles and never forms anything
// (T, T)-shaped: D = rowsum(do * o), equal to rowsum(dP * P) in exact
// arithmetic, comes from a small pre-pass, and the saved L gives P without a
// second softmax.  o is bf16, so D differs from the TPU kernel's by o's
// rounding; the plain version (spatial_attention_bwd_ref) follows the TPU
// kernel and chip_smoke.py states the tolerance between them.
//
// What bounds it on the H100: 10 T^2 DH flops per (batch, head) on the tensor
// cores (five products; 0.26 ms for the ds 1 block (8, 8, 4096, 24), and DH 24
// runs two of them to depth 32) and one exponential per logit on the special
// function units (16 ex2 per clock per SM: 0.26 ms at ds 1 and 1980 MHz).  The
// bytes (q, k, v, o, do read, dq, dk, dv written once: 0.1 GB at ds 1) are an
// order of magnitude less.  The design this one replaced ran two passes (dk/dv
// keys-major, dq queries-major) that recomputed S and dP each: 7 products, two
// exponentials per logit (0.51 ms of ex2 at ds 1), ~3.3 GB of L2 traffic, all
// on mma.sync.
//
// Design: one pass over key blocks, and two small kernels around it:
//   * delta: D = rowsum(do * o) in fp32, one thread per row;
//   * main: a block owns 128 keys of one (batch, head) and runs 3
//     warpgroups.  K and V stay in shared memory (loaded once by TMA) and
//     64-query tiles of Q, dO, L and D stream through a 5-stage TMA / mbarrier
//     ring, one swizzled box a tile (attention_sm90.cuh).
//     - Two consumer warpgroups own 64 keys each.  Per tile: S^T = K Q^T and
//       dP^T = V dO^T on wgmma m64n64k16 (operands in shared memory; DH 24
//       runs to depth 32 on the zero columns TMA fills), P^T = exp2(S^T c - L)
//       with one FFMA and one ex2 per logit, dS^T = P^T (dP^T - D) scale
//       rounded to bf16, then dV += P^T dO and dK += dS^T Q on wgmma with
//       P^T / dS^T from registers (RS) and dO / Q as MN-major operands: dk, dv
//       stay in registers for the whole pass.  Each stores its half of dS^T
//       into shared memory (two buffers) and goes on to the next tile.
//     - The third warpgroup (setmaxnreg 56 against the consumers' 224): one
//       of its threads issues every load; all of it runs dQ = dS K over the
//       128 keys per tile (wgmma, both operands MN-major) and adds the fp32
//       (64 x DH) partial into the dq_accum scratch with one TMA bulk
//       reduce-add.  So the consumers never wait for each other, and wait
//       for dQ only when they run two tiles ahead of it.
//     5 products, one exponential per logit.  Each block starts at another
//     query tile, so the blocks of one head do not add into the same rows at
//     once;
//   * dq: dq_accum (fp32) rounded to bf16.
// dk and dv do not depend on the order the blocks run in; dq does: its fp32
// sum over the key blocks is taken in the order the reduce-adds reach L2, so
// two runs may differ in its last bf16 bit (tests/test_torch_cuda.py bounds
// that).  The wrapper allocates delta and dq_accum (zeroed); the kernels
// allocate nothing.
// Registers and shared memory (ptxas -v on the H100, sm_90a): 168 registers
// a thread at launch (setmaxnreg then moves them), no spills; dynamic shared
// memory 108,664 B at DH 24 and 178,296 B at DH 48.  What still holds it back
// is in PERF.md.
//
// Only bf16 with T a multiple of 128 and DH 24 or 48 (the UNet's), every
// tensor 16-byte aligned, is taken; the Python wrapper
// (slice3d_tpu_torch/ops/spatial_attention.py) raises on anything else.  Plain
// C interface, built with nvcc into a shared library and bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

using namespace s3d_attn;

constexpr int BKEYS = 128;  // keys per block (64 per consumer warpgroup)
constexpr int BQT = 64;     // queries per streamed tile
constexpr int STAGES = 5;   // Q / dO / L / D ring depth
// 2 consumer warpgroups, setmaxnreg 56 / 224; 168 registers a thread at
// launch, one block an SM
using WS = WarpSpecialised<2, 56, 224>;
constexpr int THREADS = WS::THREADS;
constexpr int DQ_WG = 2;       // the warpgroup that loads the tiles and runs dQ
constexpr int BAR_DQ = 1;      // named barrier 1: the dQ warpgroup's partial

template <int DH>
struct Bwd {
  using R = HeadRows<DH>;
  static constexpr int KV_BYTES = BKEYS * R::ROW;
  static constexpr int T_BYTES = BQT * R::ROW;  // a Q or dO tile
  static constexpr int STAGE_BYTES = (2 * T_BYTES + 2 * BQT * 4 + 1023) / 1024 * 1024;
  static constexpr int DS_BYTES = (BQT / 8) * BKEYS * 16;  // dS, MN-major: slabs of 8 queries
  static constexpr int DQ_BYTES = BQT * DH * 4;            // the fp32 dq partial of a tile
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_STAGE = 2 * KV_BYTES;
  static constexpr int OFF_DS = OFF_STAGE + STAGES * STAGE_BYTES;
  static constexpr int OFF_DQ = OFF_DS + 2 * DS_BYTES;
  static constexpr int OFF_BAR = OFF_DQ + 2 * DQ_BYTES;
  static constexpr int N_BARS = 2 * STAGES + 5;  // full, empty, kv, ds_full[2], ds_empty[2]
  static constexpr int SMEM = OFF_BAR + N_BARS * 8 + 1024;  // + alignment slack
  static constexpr uint32_t KV_TX = 2 * KV_BYTES;
  static constexpr uint32_t TILE_TX = 2 * T_BYTES + 2 * BQT * 4;
};

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

// dq = bf16(dq_accum), four values a thread.
__global__ void attention_bwd_dq_kernel(const float4* __restrict__ acc,
                                        uint2* __restrict__ dq, size_t n4) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4 x = acc[i];
  dq[i] = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1) attention_bwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq_accum, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int t, float c, float scale) {
  using C = Bwd<DH>;
  using R = typename C::R;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = smem;
  uint8_t* vs = smem + C::OFF_V;
  uint8_t* stages = smem + C::OFF_STAGE;  // per stage: Q tile, dO tile, L, D
  uint8_t* dss = smem + C::OFF_DS;        // dS of two tiles
  float* dqs = reinterpret_cast<float*>(smem + C::OFF_DQ);  // dq partials of two tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;
  uint64_t* ds_full = kvbar + 1;     // [2]: both consumers stored dS
  uint64_t* ds_empty = ds_full + 2;  // [2]: the dQ product read it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const bool leader = (tid & 127) == 0;
  const int n_kblocks = t / BKEYS;
  const int bh = blockIdx.x / n_kblocks;
  const int kb = blockIdx.x % n_kblocks;
  const int k0 = kb * BKEYS;
  const int row0 = bh * t;  // first row of this head in the (bh t, DH) views
  const int n_tiles = t / BQT;
  // the query tile of step j: each key block starts elsewhere, so the blocks
  // of a head add into different dq rows at a time
  auto tile_of = [&](int j) { return (j + kb * (n_tiles / n_kblocks)) % n_tiles; };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(kvbar, 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(&ds_full[b], 256);  // every consumer thread, after its stores
      mbar_init(&ds_empty[b], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // swizzled rows: 64 rows of K / V as K-major A and a Q / dO tile as K-major
  // B (a k16 step is 32 bytes along the row: contraction over DH); a Q / dO
  // tile as MN-major B (contraction over the queries) and K as MN-major B
  // (over the keys; a k16 step is 16 rows); dS (un-swizzled slabs) as
  // MN-major A (over the keys)
  auto kv_a = [&](const uint8_t* tile, int kk) {
    return smem_desc(tile + wg * 64 * R::ROW + kk * 32, 16, R::SBO, R::LAYOUT);
  };
  auto tile_k = [&](const uint8_t* tile, int kk) {
    return smem_desc(tile + kk * 32, 16, R::SBO, R::LAYOUT);
  };
  auto rows_mn = [&](const uint8_t* tile, int kk) {
    return smem_desc(tile + kk * 16 * R::ROW, 16, R::SBO, R::LAYOUT);
  };
  auto ds_mn = [&](const uint8_t* tile, int kk) {
    return smem_desc(tile + kk * 16 * 16, 128, BKEYS * 16);
  };

  if (wg == DQ_WG) {
    // ---- the dQ warpgroup: one thread keeps the tiles coming; all of it
    // runs dQ = dS K (64 queries x DH over the block's 128 keys) per tile and
    // adds the fp32 partial into dq_accum with one bulk reduce-add
    regs_dec<WS::PRODUCER>();
    auto load_tile = [&](int j) {
      const int s = j % STAGES, q0 = tile_of(j) * BQT, qrow = row0 + q0;
      if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      uint8_t* st = stages + s * C::STAGE_BYTES;
      mbar_expect_tx(&full[s], C::TILE_TX);
      tma_load_3d(st, &tq, &full[s], 0, q0, bh);
      tma_load_3d(st + C::T_BYTES, &tdo, &full[s], 0, q0, bh);
      bulk_load(st + 2 * C::T_BYTES, lse + qrow, BQT * 4, &full[s]);
      bulk_load(st + 2 * C::T_BYTES + BQT * 4, delta + qrow, BQT * 4, &full[s]);
    };
    if (leader) {
      mbar_expect_tx(kvbar, C::KV_TX);
      tma_load_3d(ks, &tk, kvbar, 0, k0, bh);
      tma_load_3d(vs, &tv, kvbar, 0, k0, bh);
      for (int j = 0; j < STAGES && j < n_tiles; ++j) load_tile(j);
    }
    mbar_wait(kvbar, 0);
#pragma unroll 1
    for (int j = 0; j < n_tiles; ++j) {
      // the tile STAGES - 1 ahead, into the stage the consumers freed last
      if (leader && j >= 1 && j + STAGES - 1 < n_tiles) load_tile(j + STAGES - 1);
      const int b = j & 1;
      mbar_wait(&ds_full[b], (j >> 1) & 1);
      float dq_acc[DH / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKEYS / 16; ++kk)
        wgmma_ss<DH, 1, 1>(dq_acc, ds_mn(dss + b * C::DS_BYTES, kk), rows_mn(ks, kk), kk);
      wgmma_commit();
      reg_fence(dq_acc);
      wgmma_wait<0>();
      reg_fence(dq_acc);
      if (leader) {
        mbar_arrive(&ds_empty[b]);
        bulk_wait_read<1>();  // the reduce-add of tile j - 2 has read buffer b
      }
      named_sync(BAR_DQ, 128);
      float* buf = dqs + b * (BQT * DH);
#pragma unroll
      for (int jn = 0; jn < DH / 8; ++jn) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(buf + (wl * 16 + g + 8 * h) * DH + 8 * jn + 2 * t4) =
              make_float2(dq_acc[4 * jn + 2 * h], dq_acc[4 * jn + 2 * h + 1]);
        }
      }
      fence_proxy_async();
      named_sync(BAR_DQ, 128);
      if (leader)
        bulk_reduce_add_f32(dq_accum + (size_t(row0) + size_t(tile_of(j)) * BQT) * DH, buf,
                            C::DQ_BYTES);
    }
    if (leader) bulk_wait<0>();
  } else {
    // ---- a consumer warpgroup: 64 keys; dk, dv in registers for the pass
    regs_inc<WS::CONSUMER>();
    float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kvbar, 0);
#pragma unroll 1
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES, b = j & 1;
      const uint8_t* qt = stages + s * C::STAGE_BYTES;
      const uint8_t* dot = qt + C::T_BYTES;
      const float* lt = reinterpret_cast<const float*>(qt + 2 * C::T_BYTES);
      const float* dlt = lt + BQT;
      uint8_t* dsb = dss + b * C::DS_BYTES;
      mbar_wait(&full[s], (j / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 queries
      float sacc[32], dpacc[32];
      reg_fence(dk_acc);
      reg_fence(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R::DEPTH; ++kk)
        wgmma_ss<64, 0, 0>(sacc, kv_a(ks, kk), tile_k(qt, kk), kk);
#pragma unroll
      for (int kk = 0; kk < R::DEPTH; ++kk)
        wgmma_ss<64, 0, 0>(dpacc, kv_a(vs, kk), tile_k(dot, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sacc);
      reg_fence(dpacc);

      // P^T = exp2(S^T c - L) and dS^T = P^T (dP^T - D) scale; element
      // 4 jn + 2 h + e is key 16 wl + g + 8 h, query 8 jn + 2 t4 + e
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const float2 lq = *reinterpret_cast<const float2*>(lt + 8 * jn + 2 * t4);
        const float2 dd = *reinterpret_cast<const float2*>(dlt + 8 * jn + 2 * t4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * jn + 2 * h;
          const float p0 = exp2_approx(fmaf(sacc[i], c, -lq.x));
          const float p1 = exp2_approx(fmaf(sacc[i + 1], c, -lq.y));
          sacc[i] = p0;
          sacc[i + 1] = p1;
          dpacc[i] = p0 * (dpacc[i] - dd.x) * scale;
          dpacc[i + 1] = p1 * (dpacc[i + 1] - dd.y) * scale;
        }
      }
      uint32_t pa[4][4], da[4][4];
      acc_to_a(pa, sacc);
      acc_to_a(da, dpacc);

      // dV += P^T dO and dK += dS^T Q over the tile's queries
      reg_fence(pa);
      reg_fence(da);
      reg_fence(dk_acc);
      reg_fence(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQT / 16; ++kk) wgmma_rs<DH, 1>(dv_acc, pa[kk], rows_mn(dot, kk));
#pragma unroll
      for (int kk = 0; kk < BQT / 16; ++kk) wgmma_rs<DH, 1>(dk_acc, da[kk], rows_mn(qt, kk));
      wgmma_commit();
      reg_fence(dk_acc);
      reg_fence(dv_acc);

      // dS^T into shared memory for the dQ warpgroup, under the products:
      // query slab q / 8, key row, 16 bytes a row
      if (j >= 2) mbar_wait(&ds_empty[b], ((j >> 1) & 1) ^ 1);
      {
        const int key = wg * 64 + wl * 16 + g;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {  // queries 16 kk + 8 half + 2 t4
            uint8_t* slab = dsb + (2 * kk + half) * BKEYS * 16 + 4 * t4;
            *reinterpret_cast<uint32_t*>(slab + key * 16) = da[kk][2 * half];
            *reinterpret_cast<uint32_t*>(slab + (key + 8) * 16) = da[kk][2 * half + 1];
          }
        }
      }
      fence_proxy_async();
      mbar_arrive(&ds_full[b]);

      wgmma_wait<0>();
      reg_fence(dv_acc);
      reg_fence(dk_acc);
      reg_fence(pa);
      reg_fence(da);
      if (leader) mbar_arrive(&empty[s]);
    }

    // dk, dv of this warpgroup's 64 keys, bf16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = size_t(row0) + k0 + wg * 64 + wl * 16 + g + 8 * h;
#pragma unroll
      for (int jn = 0; jn < DH / 8; ++jn) {
        const int i = 4 * jn + 2 * h;
        *reinterpret_cast<uint32_t*>(dk + row * DH + 8 * jn + 2 * t4) =
            pack_bf16(dk_acc[i], dk_acc[i + 1]);
        *reinterpret_cast<uint32_t*>(dv + row * DH + 8 * jn + 2 * t4) =
            pack_bf16(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, float* dq_accum, void* dq, void* dk, void* dv,
           int bh, int t, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  static DevicePrep prep;
  int sms = 0;
  const int prepared =
      prepare_on_device(prep, attention_bwd_kernel<DH>, Bwd<DH>::SMEM, WS::MIN_LAUNCH, &sms);
  if (prepared != 0) return prepared;
  CUtensorMap tq, tk, tv, tdo;
  constexpr int W = HeadRows<DH>::W;
  if (encode_rows(&tq, q, bh, t, DH, W, BQT) || encode_rows(&tk, k, bh, t, DH, W, BKEYS) ||
      encode_rows(&tv, v, bh, t, DH, W, BKEYS) || encode_rows(&tdo, dout, bh, t, DH, W, BQT))
    return -2;
  const int n_rows = bh * t;
  attention_bwd_delta_kernel<DH><<<(n_rows + 255) / 256, 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  attention_bwd_kernel<DH><<<unsigned(bh) * unsigned(t / BKEYS), THREADS, Bwd<DH>::SMEM,
                             stream>>>(tq, tk, tv, tdo, lse, delta, dq_accum,
                                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), t,
                                       scale * 1.4426950408889634f, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const size_t n4 = size_t(n_rows) * DH / 4;
  attention_bwd_dq_kernel<<<unsigned((n4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dq_accum), static_cast<uint2*>(dq), n4);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o (the forward's output), dout, dq, dk, dv: contiguous bf16
// (bh, t, dh), 16-byte aligned; lse: the forward's fp32 (bh, t) row
// log-sum-exp (log2 units); delta: fp32 (bh, t) scratch; dq_accum: fp32
// (bh, t, dh) scratch, zero on entry.  Returns 0 on success, the cudaError_t
// of a launch, -1 for a shape the kernels do not take, -2 if a tensor map
// cannot be encoded, -3 if the kernel was built with too few registers for
// its setmaxnreg, -4 on a device ordinal past MAX_DEVICES.  The kernels
// launch on the host thread's current device.
int s3d_spatial_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* delta, void* dq_accum,
                              void* dq, void* dk, void* dv, int bh, int t, int dh, float scale,
                              void* stream) {
  if (bh <= 0 || t <= 0 || t % BKEYS != 0 || t % BQT != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  float* acc = static_cast<float*>(dq_accum);
  switch (dh) {
    case 24: return launch<24>(q, k, v, o, dout, l, d, acc, dq, dk, dv, bh, t, scale, s);
    case 48: return launch<48>(q, k, v, o, dout, l, d, acc, dq, dk, dv, bh, t, scale, s);
    default: return -1;
  }
}

}  // extern "C"
