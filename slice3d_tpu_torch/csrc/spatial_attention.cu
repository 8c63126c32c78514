// Softmax attention over the LDM UNet's flattened feature maps (forward, bf16).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_attention.py::_attention_forward
// (pallas_call at :59, body _attn_kernel).  For every (batch, head) of q, k, v
// (B, H, T, DH):
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
// rounding of the probabilities (chip_smoke.py states the tolerance).
//
// What bounds it on the H100, at the UNet's head widths (DH 24 at T 4096, DH 48
// at T 1024):
//   * exponentials: one per logit on the special function units (16 ex2 per
//     clock per SM): 0.26 ms for the ds 1 block (8, 8, 4096, 24) at 1980 MHz,
//     0.016 ms for the ds 2 block (8, 8, 1024, 48);
//   * tensor cores: 4 T^2 DH flops per head, under half the exponentials' time
//     at DH 24 (padded to 32 for Q K^T) and about as long at DH 48, but only
//     through wgmma: mma.sync reaches a fraction of Hopper's rate;
//   * L2 -> shared memory: every block of queries streams all T keys of its
//     head.  With 64 query rows a block (the design this one replaced) that
//     was ~1.6 GB a call at ds 1 and ~0.2 GB at ds 2; and TMA pays per row of
//     a box, so a tile must arrive in few, wide boxes;
//   * HBM: q, k, v read and out written once, 50 MB at ds 1: not a bound.
//
// Design: persistent blocks of 2 consumer warpgroups and 1 producer
// warpgroup; a block takes query blocks of 128 rows of one (batch, head) in
// turn, so each K/V tile crosses L2 once per 128 queries (half the bytes of
// 64-row blocks) and the next query block's loads run under this one's work.
//   * one thread of the producer loads Q (two buffers) and keeps 128-key K/V
//     tiles in flight by TMA into a ring of mbarriers (full: the TMA's bytes
//     landed; empty: both consumers are done with the stage), one box a tile
//     in TMA's swizzled layout (attention_sm90.cuh); the producer warpgroup
//     gives its registers to the consumers (setmaxnreg 40 / 232).  The ring
//     holds 6 tiles at DH 24 and 4 at DH 48 (what shared memory allows);
//     against 3, that read ~2% faster at ds 1.  A 2-CTA cluster whose
//     blocks each load half of a tile and multicast it to both (half the L2
//     traffic) read no faster than the deeper ring, with or without it, so
//     the kernel does without it (PERF.md);
//   * each consumer warpgroup owns 64 query rows and walks the keys in
//     64-key halves: S = Q K^T on wgmma m64n64k16 with both operands in shared
//     memory (K-major; DH 24 runs to depth 32 on the zero columns TMA fills),
//     O += P V on wgmma m64nDHk16 with P in registers (the fp32 accumulator
//     repacked as bf16 A fragments) and V as an MN-major operand;
//   * softmax: the running max is taken on the raw S (scale > 0), and each
//     logit costs one FFMA and one ex2: exp2(s c - m c), c = scale log2(e);
//     row sums in fp32;
//   * overlap: the next half's S is issued before this half's softmax, and
//     the previous half's P V runs under it.  The two warpgroups do not take
//     turns: a ping-pong on named barriers (one warpgroup's exponentials
//     under the other's products) was slower in a development build, as each
//     warpgroup already keeps its own products in flight under its softmax
//     (PERF.md);
//   * when asked (the autograd path), the row's log-sum-exp in log2 units,
//     L = m c + log2(l), is written in fp32 for the backward
//     (csrc/spatial_attention_bwd.cu), which recomputes P = exp2(S c - L).
// Registers and shared memory (ptxas -v on the H100, sm_90a): 168 registers
// a thread at launch (setmaxnreg then moves them), no spills; dynamic shared
// memory (Fwd::SMEM) 115,840 B at DH 24 and 164,960 B at DH 48.  What still
// holds it back is in PERF.md.
//
// Only bf16 q/k/v are taken, with T a multiple of 128 and DH 24 or 48 (the
// UNet's), every tensor 16-byte aligned; the Python wrapper
// (slice3d_tpu_torch/ops/spatial_attention.py) raises on anything else.  Plain
// C interface, built with nvcc into a shared library and bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

using namespace s3d_attn;

// 2 consumer warpgroups of 64 query rows, setmaxnreg 40 / 232; 168
// registers a thread at launch, one block an SM
using WS = WarpSpecialised<2, 40, 232>;
constexpr int THREADS = WS::THREADS;
constexpr int BQ = 128;      // query rows per query block
constexpr int BK = 128;      // keys per K/V tile
constexpr int PRODUCER_WARP = 8;  // the first warp of the producer warpgroup

template <int DH>
struct Fwd {
  using R = HeadRows<DH>;
  static constexpr int STAGES = DH <= 32 ? 6 : 4;  // K/V ring depth
  static constexpr int Q_BYTES = BQ * R::ROW;
  static constexpr int KV_BYTES = BK * R::ROW;
  static constexpr int OFF_K = 2 * Q_BYTES;  // two Q buffers: the next block's loads early
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  static constexpr int SMEM = OFF_BAR + (2 * STAGES + 4) * 8 + 1024;  // + alignment slack
  static constexpr uint32_t TILE_TX = 2 * KV_BYTES;  // TMA bytes of a K/V stage
};

// Persistent: block b takes the query blocks b, b + gridDim.x, ... (a query
// block is BQ rows of one (batch, head)), so the producer loads the next
// block's Q and K/V while the consumers finish this one.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1) attention_fwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int t, int n_items, float c) {
  using C = Fwd<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* ks = smem + C::OFF_K;
  uint8_t* vs = smem + C::OFF_V;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qfull = empty + C::STAGES;  // [2]
  uint64_t* qempty = qfull + 2;      // [2]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_qblocks = t / BQ;
  const int n_tiles = t / BK;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&qfull[b], 1);
      mbar_init(&qempty[b], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= PRODUCER_WARP) {  // the producer warpgroup: one thread issues every load
    regs_dec<WS::PRODUCER>();
    if (warp == PRODUCER_WARP && lane == 0) {
      int gt = 0;  // K/V tiles loaded so far, over all of this block's query blocks
      for (int i = 0, item = blockIdx.x; item < n_items; ++i, item += gridDim.x) {
        const int b = i & 1;
        const int bh = item / n_qblocks, q0 = (item % n_qblocks) * BQ;
        if (i >= 2) mbar_wait(&qempty[b], ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(&qfull[b], C::Q_BYTES);
        tma_load_3d(qs + b * C::Q_BYTES, &tq, &qfull[b], 0, q0, bh);
        for (int j = 0; j < n_tiles; ++j, ++gt) {
          const int s = gt % C::STAGES;
          if (gt >= C::STAGES) mbar_wait(&empty[s], ((gt / C::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], C::TILE_TX);
          tma_load_3d(ks + s * C::KV_BYTES, &tk, &full[s], 0, j * BK, bh);
          tma_load_3d(vs + s * C::KV_BYTES, &tv, &full[s], 0, j * BK, bh);
        }
      }
    }
  } else {
    regs_inc<WS::CONSUMER>();
    const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
    const bool leader = (tid & 127) == 0;

    // descriptors (swizzled rows): Q rows 64 wg .. of a Q buffer and K rows
    // as K-major operands (a k16 step is 32 bytes along the row), V rows as
    // an MN-major operand (a k16 step is 16 rows)
    using R = typename C::R;
    auto q_desc = [&](int b, int kk) {
      return smem_desc(qs + b * C::Q_BYTES + wg * 64 * R::ROW + kk * 32, 16, R::SBO,
                       R::LAYOUT);
    };
    auto k_desc = [&](int s, int kk, int h) {  // keys 64 h .. 64 h + 63 of the tile
      return smem_desc(ks + s * C::KV_BYTES + h * 64 * R::ROW + kk * 32, 16, R::SBO,
                       R::LAYOUT);
    };
    auto v_desc = [&](int s, int kk) {
      return smem_desc(vs + s * C::KV_BYTES + kk * 16 * R::ROW, 16, R::SBO, R::LAYOUT);
    };
    // the products of one 64-key half h of the tile in stage s: S = Q K^T
    // (into a fresh accumulator) and O += P V, each its own commit group
    auto issue_s = [&](float (&sacc)[32], int b, int s, int h) {
#pragma unroll
      for (int kk = 0; kk < R::DEPTH; ++kk)
        wgmma_ss<64, 0, 0>(sacc, q_desc(b, kk), k_desc(s, kk, h), kk);
      wgmma_commit();
    };
    auto issue_pv = [&](float (&acc)[DH / 2], const uint32_t (&pa)[4][4], int s, int h) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<DH, 1>(acc, pa[kk], v_desc(s, 4 * h + kk));
      wgmma_commit();
    };
    auto start_s = [&](float (&sacc)[32], int b, int s, int h) {
      reg_fence(sacc);
      wgmma_fence();
      issue_s(sacc, b, s, h);
      reg_fence(sacc);
    };
    auto rescale = [&](float (&acc)[DH / 2], const float (&alpha)[2]) {
#pragma unroll
      for (int jn = 0; jn < DH / 8; ++jn) {
        acc[4 * jn + 0] *= alpha[0];
        acc[4 * jn + 1] *= alpha[0];
        acc[4 * jn + 2] *= alpha[1];
        acc[4 * jn + 3] *= alpha[1];
      }
    };

    int gt = 0;  // K/V tiles consumed so far
#pragma unroll 1
    for (int i = 0, item = blockIdx.x; item < n_items; ++i, item += gridDim.x) {
      const int b = i & 1;
      const int row0 = (item / n_qblocks) * t, q0 = (item % n_qblocks) * BQ;
      float o[DH / 2];
#pragma unroll
      for (int r = 0; r < DH / 2; ++r) o[r] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
      float sa[32], sb[32];  // S of the even and the odd 64-key halves
      uint32_t p[4][4];

      // 64-key halves u = 0, 1, ...: S(u + 1) is issued before the softmax
      // of u ends and P(u - 1) V runs under that softmax.  The schedule is
      // unrolled by a whole tile (two halves), with the first and the last
      // tile peeled, so no branch separates a wgmma from its wait (ptxas
      // would serialise the products if one did).
      mbar_wait(&qfull[b], (i >> 1) & 1);
      int s = gt % C::STAGES;
      mbar_wait(&full[s], (gt / C::STAGES) & 1);
      start_s(sa, b, s, 0);
      wgmma_wait<0>();
      reg_fence(sa);
      online_softmax_step(sa, m, l, alpha, c);
      start_s(sb, b, s, 1);
      acc_to_a(p, sa);
#pragma unroll 1
      for (int j = 0; j + 1 < n_tiles; ++j) {
        const int sn = (gt + j + 1) % C::STAGES;
        // P(2j) V while S(2j + 1) lands; then S(2j + 2) from the next tile
        reg_fence(o);
        reg_fence(p);
        wgmma_fence();
        issue_pv(o, p, s, 0);
        reg_fence(o);
        wgmma_wait<1>();
        reg_fence(sb);
        online_softmax_step(sb, m, l, alpha, c);
        mbar_wait(&full[sn], ((gt + j + 1) / C::STAGES) & 1);
        start_s(sa, b, sn, 0);
        wgmma_wait<1>();
        reg_fence(o);
        reg_fence(p);
        rescale(o, alpha);
        acc_to_a(p, sb);
        // P(2j + 1) V while S(2j + 2) lands; then S(2j + 3)
        reg_fence(o);
        reg_fence(p);
        wgmma_fence();
        issue_pv(o, p, s, 1);
        reg_fence(o);
        wgmma_wait<1>();
        reg_fence(sa);
        online_softmax_step(sa, m, l, alpha, c);
        start_s(sb, b, sn, 1);
        wgmma_wait<1>();
        reg_fence(o);
        reg_fence(p);
        if (leader) mbar_arrive(&empty[s]);  // both halves of V read
        rescale(o, alpha);
        acc_to_a(p, sa);
        s = sn;
      }
      // the last tile: P(2n - 2) V, the softmax of S(2n - 1), P(2n - 1) V
      reg_fence(o);
      reg_fence(p);
      wgmma_fence();
      issue_pv(o, p, s, 0);
      reg_fence(o);
      wgmma_wait<1>();
      reg_fence(sb);
      if (leader) mbar_arrive(&qempty[b]);  // every S of this block has landed
      online_softmax_step(sb, m, l, alpha, c);
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(p);
      rescale(o, alpha);
      acc_to_a(p, sb);
      reg_fence(o);
      reg_fence(p);
      wgmma_fence();
      issue_pv(o, p, s, 1);
      reg_fence(o);
      wgmma_wait<0>();
      reg_fence(o);
      if (leader) mbar_arrive(&empty[s]);
      gt += n_tiles;

      // divide by the row sums and write bf16
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sum = l[h];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.f / sum;
        const int row = q0 + wg * 64 + wl * 16 + g + 8 * h;
        if (lse != nullptr && t4 == 0) lse[size_t(row0) + row] = m[h] * c + log2f(sum);
        __nv_bfloat16* dst = out + (size_t(row0) + row) * DH;
#pragma unroll
        for (int jn = 0; jn < DH / 8; ++jn) {
          *reinterpret_cast<uint32_t*>(dst + 8 * jn + 2 * t4) =
              pack_bf16(o[4 * jn + 2 * h] * inv, o[4 * jn + 2 * h + 1] * inv);
        }
      }
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int bh, int t,
           float scale, cudaStream_t stream) {
  static DevicePrep prep;
  int sms = 0;  // one persistent block an SM
  const int prepared =
      prepare_on_device(prep, attention_fwd_kernel<DH>, Fwd<DH>::SMEM, WS::MIN_LAUNCH, &sms);
  if (prepared != 0) return prepared;
  CUtensorMap tq, tk, tv;
  constexpr int W = HeadRows<DH>::W;
  if (encode_rows(&tq, q, bh, t, DH, W, BQ) || encode_rows(&tk, k, bh, t, DH, W, BK) ||
      encode_rows(&tv, v, bh, t, DH, W, BK))
    return -2;
  const int n_items = bh * (t / BQ);
  const int grid = n_items < sms ? n_items : sms;
  attention_fwd_kernel<DH><<<grid, THREADS, Fwd<DH>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, t, n_items,
      scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, out: contiguous bf16 (bh, t, dh), 16-byte aligned; lse: fp32
// (bh, t) or null (the rows' log-sum-exp of S * scale in log2 units, written
// only when given).  Returns 0 on success, the cudaError_t of the launch, -1
// for a shape the kernel does not take, -2 if a tensor map cannot be encoded,
// -3 if the kernel was built with too few registers for its setmaxnreg, -4
// on a device ordinal past MAX_DEVICES.  The kernel launches on the host
// thread's current device.
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
