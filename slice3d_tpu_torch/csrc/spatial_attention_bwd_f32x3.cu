// Softmax attention over the LDM UNet's flattened feature maps: backward
// (fp32, 3xTF32 on Hopper's tensor cores).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_attention.py::_attention_backward
// (pallas_call at :150, body _attn_bwd_kernel) for fp32 inputs, the training
// precision of the JAX package's root CLI.  For every (batch, head), from q,
// k, v, the forward's output o and the row log-sum-exp L it saved
// (csrc/spatial_attention_f32x3.cu), and the output's gradient do, all
// (B, H, T, DH) fp32:
//
//   P  = softmax(q k^T * scale)              recomputed, P = exp2(S c - L)
//   dP = do v^T
//   dS = P * (dP - D) * scale, D = rowsum(do * o)
//   dq = dS k,  dk = dS^T q,  dv = P^T do
//
// in fp32 in and out.  Every product runs on the tensor cores as three TF32
// products of split operands (csrc/attention_sm90.cuh: x = hi + lo, d +=
// lo.hi + hi.lo + hi.hi), which keeps fp32's accuracy where one TF32 product
// (10 bits of mantissa) would not.  The tensor cores sum each tile's products
// in their fp32 accumulator; the gradients are summed over the tiles in fp32
// on the CUDA cores, in a fixed order.  D = rowsum(do o) equals the TPU
// kernel's rowsum(dP P) in exact arithmetic; the plain version
// (spatial_attention_bwd_ref) follows the TPU kernel, so kernel and plain
// version differ by rounding, summation order and the exponential.
//
// What bounds it on the H100: the products, 10 T^2 DH flops per head in five
// products, as 3 TF32 products each on the tensor cores (132 SMs x 2,048
// TF32 flops a clock: 535 TFLOP/s at 1980 MHz, an fp32 rate of 178 TFLOP/s):
// 1.44 ms for the ds 1 block (8, 8, 4096, 24), 0.18 ms for the ds 2 block
// (8, 8, 1024, 48); one exponential per logit on the special function units
// (0.26 ms at ds 1).  This design does seven products (S and dP twice,
// 2.02 / 0.25 ms) and two exponentials per logit, so that every gradient is
// summed inside one block, with no atomics and no cross-block reduce: two
// runs give the same bits.  The bytes (q, k, v, o, do read, dq, dk, dv
// written once: 0.2 GB at ds 1, 0.06 ms) are a thirtieth of the bound.
//
// Design: two warp-specialised kernels of three warpgroups (384 threads), a
// block over 128 rows of one (batch, head), one block an SM, streaming the
// other side in tiles of TILE rows (64 at DH 24, 32 at DH 48):
//   * dq (launched first): a block owns 128 queries, 64 for each of two
//     consumer warpgroups, which compute their D = rowsum(do * o) (written
//     to `delta` for the second kernel) and split their q and do rows into
//     hi/lo planes (the A operands of S = q k^T and dP = do v^T), then walk
//     over the key tiles: S and dP on wgmma (SS), P = exp2(S c - L) under
//     the dP products, dS in registers, dQ += dS k on wgmma with dS's split
//     fragments from registers (RS) and k^T as a K-major plane;
//   * dk/dv: a block owns 128 keys, whose k and v rows the consumers split
//     into planes (the A operands of S^T = k q^T and dP^T = v do^T), then
//     walk over the query tiles: S^T and dP^T (SS), P^T and dS^T in
//     registers, dV += P^T do and dK += dS^T q (RS) with q^T and do^T as
//     K-major planes, in two halves of the tile so that one half's split
//     fragments are live at a time.
// tf32 operands must be K-major, so every tile is split into the planes both
// products read: as it lies (rows x head) and transposed (head x rows, the
// rows permuted within each 8 so that an accumulator's k8 block is the RS
// fragment as it lies: kperm in attention_sm90.cuh).  The third warpgroup
// (setmaxnreg 72 against the consumers' 216) does that: one of its threads
// streams the raw tiles (the rows of one head are contiguous) with 1-D bulk
// copies on mbarriers, two tiles ahead, and all of it splits each raw tile
// into one of two stages of planes while the consumers run their products
// on the other; full / empty mbarriers hand the stages over (its loop and
// the split helpers are attention_sm90.cuh's, shared with the forward).  So
// the split runs beside the products, and a tile is split once for 128
// rows.  The wrapper allocates delta; the kernels allocate nothing.
// Registers and shared memory (ptxas -v on the H100, sm_90a): 168 registers
// a thread at launch, no spills; dynamic shared memory 174,128 B (dk/dv) and
// 148,528 B (dq) at DH 24, 222,256 B and 197,680 B at DH 48.
//
// Only fp32 with T a multiple of 128, DH 24 or 48 (the UNet's), every tensor
// 16-byte aligned, is taken; the Python wrapper
// (slice3d_tpu_torch/ops/spatial_attention.py) raises on anything else.  Plain
// C interface, built with nvcc into a shared library and bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

using namespace s3d_attn;

constexpr int BROWS = 128;   // keys of a dk/dv block, queries of a dq block
constexpr int TILE24 = 64;   // rows of a streamed tile at DH 24
constexpr int TILE48 = 32;   // rows of a streamed tile at DH 48
constexpr int CONSUMERS = 2;  // consumer warpgroups, 64 of the block's rows each
// and the warpgroup that splits the tiles: 168 registers a thread at launch,
// setmaxnreg 72 / 216
using WS = WarpSpecialised<CONSUMERS, 72, 216>;
constexpr int THREADS = WS::THREADS;
constexpr int SPLITTER = CONSUMERS;  // the splitting warpgroup
constexpr int BAR_SPLIT = 1;         // named barriers: 1 the splitter, 2 + w consumer w

// Shared memory of a kernel (bytes from the start): the block's rows as hi,
// lo planes of two tensors (k, v for dk/dv; q, do for dq); two stages of
// the tile's planes (dk/dv: q, do, q^T, do^T and the tile's L, D; dq: k, v,
// k^T); two raw tiles (the bulk copies' targets: q, do, L, D or k, v); dq:
// L, D of the block's rows; the mbarriers raw_full[2], full[2], empty[2].
template <int DH, bool KV>
struct X3 {
  static constexpr int TILE = DH == 24 ? TILE24 : TILE48;
  static constexpr int KS = DH / 8;    // k8 steps over the head
  static constexpr int TS = TILE / 8;  // k8 steps over a tile
  static constexpr int ROWS_PLANE = BROWS * DH * 4;
  static constexpr int TILE_PLANE = TILE * DH * 4;  // a tile's plane, or its raw rows
  static constexpr int LD = KV ? 2 * TILE * 4 : 0;  // a tile's L and D
  static constexpr int STAGE = (KV ? 8 : 6) * TILE_PLANE + LD;
  static constexpr int RAW = 2 * TILE_PLANE + LD;
  static constexpr int OFF_STAGE = 4 * ROWS_PLANE;
  static constexpr int OFF_RAW = OFF_STAGE + 2 * STAGE;
  static constexpr int OFF_LD = OFF_RAW + 2 * RAW;
  static constexpr int OFF_BAR = OFF_LD + (KV ? 0 : 2 * BROWS * 4);
  static constexpr int SMEM = OFF_BAR + 6 * 8;
  static_assert(SMEM <= 232448, "shared memory over the per-block limit");
};

// Block b owns the queries (b % (t / BROWS)) * BROWS .. + BROWS - 1 of the
// (batch, head) b / (t / BROWS), 64 for each consumer warpgroup.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1) attention_bwd_dq_x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dq, int t,
    float c, float scale) {
  using C = X3<DH, false>;
  constexpr int TILE = C::TILE, TP = C::TILE_PLANE;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* qh = smem;
  uint8_t* ql = qh + C::ROWS_PLANE;
  uint8_t* doh = ql + C::ROWS_PLANE;
  uint8_t* dol = doh + C::ROWS_PLANE;
  uint8_t* stages = smem + C::OFF_STAGE;  // a stage: k, v, k^T planes (hi, lo)
  uint8_t* raws = smem + C::OFF_RAW;      // a raw tile: k rows, v rows
  float* ls = reinterpret_cast<float*>(smem + C::OFF_LD);
  float* dsum = ls + BROWS;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = raw_full + 2;
  uint64_t* empty = full + 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2, wl = warp & 3;
  const int n_blocks = t / BROWS;
  const size_t head = size_t(blockIdx.x / n_blocks) * t;
  const size_t row0 = head + size_t(blockIdx.x % n_blocks) * BROWS;
  const int n_tiles = t / TILE;
  split_bars_init(raw_full, 4 * CONSUMERS);

  if (wg == SPLITTER) {
    regs_dec<WS::PRODUCER>();
    splitter_loop(
        tid - 128 * SPLITTER, BAR_SPLIT, n_tiles, C::RAW, C::STAGE, raws, stages, raw_full, full, empty,
        [&](const float* raw, uint8_t* st, int pt) {
          split_rows<TILE, TILE, DH, 128>(raw, st, st + TP, 0, pt);
          split_rows<TILE, TILE, DH, 128>(raw + TILE * DH, st + 2 * TP, st + 3 * TP, 0, pt);
          split_cols<TILE, DH, 128>(raw, st + 4 * TP, st + 5 * TP, pt);
        },
        [&](int j) {  // the raw k, v rows of key tile j
          uint8_t* dst = raws + (j & 1) * C::RAW;
          const size_t r = head + size_t(j) * TILE;
          mbar_expect_tx(&raw_full[j & 1], C::RAW);
          bulk_load(dst, k + r * DH, TP, &raw_full[j & 1]);
          bulk_load(dst + TP, v + r * DH, TP, &raw_full[j & 1]);
        });
    return;
  }

  regs_inc<WS::CONSUMER>();
  const int wt = tid & 127, r0 = 64 * wg;
  split_rows<64, BROWS, DH, 128>(q + (row0 + r0) * DH, qh, ql, r0, wt);
  split_rows<64, BROWS, DH, 128>(dout + (row0 + r0) * DH, doh, dol, r0, wt);
  {  // D = rowsum(do * o), two threads a row, each half a row in order
    const int r = r0 + (wt >> 1), part = wt & 1;
    const float4* a = reinterpret_cast<const float4*>(o + (row0 + r) * DH + part * (DH / 2));
    const float4* b = reinterpret_cast<const float4*>(dout + (row0 + r) * DH + part * (DH / 2));
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const float4 x = a[i], y = b[i];
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
      s = fmaf(x.z, y.z, s);
      s = fmaf(x.w, y.w, s);
    }
    const float other = __shfl_xor_sync(0xffffffffu, s, 1);
    if (part == 0) {
      const float d = s + other;
      dsum[r] = d;
      delta[row0 + r] = d;
      ls[r] = lse[row0 + r];
    }
  }
  fence_proxy_async();
  named_sync(2 + wg, 128);
  // this thread's rows r0 + 16 wl + g (h = 0) and + 8 (h = 1)
  const int rr = r0 + 16 * wl + g;
  const float l0 = ls[rr], l1 = ls[rr + 8], d0 = dsum[rr], d1 = dsum[rr + 8];

  float dq_tot[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq_tot[i] = 0.f;

#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    const int b = j & 1;
    mbar_wait(&full[b], (j >> 1) & 1);
    const uint8_t* st = stages + b * C::STAGE;

    // S = q k^T and dP = do v^T: 64 queries x TILE keys
    float s[TILE / 2], dp[TILE / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk)
      tf32x3_ss<TILE>(s, plane_desc<BROWS>(qh, r0, kk), plane_desc<BROWS>(ql, r0, kk),
                      plane_desc<TILE>(st, 0, kk), plane_desc<TILE>(st + TP, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk)
      tf32x3_ss<TILE>(dp, plane_desc<BROWS>(doh, r0, kk), plane_desc<BROWS>(dol, r0, kk),
                      plane_desc<TILE>(st + 2 * TP, 0, kk), plane_desc<TILE>(st + 3 * TP, 0, kk),
                      kk);
    wgmma_commit();

    // P = exp2(S c - L) while dP runs, then dS = P (dP - D) scale; element
    // 4 jn + 2 h + e is query rr + 8 h, key 8 jn + 2 t4 + e
    wgmma_wait<1>();
    reg_fence(s);
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) s[i] = exp2_approx(fmaf(s[i], c, -((i & 2) ? l1 : l0)));
    wgmma_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) dp[i] = s[i] * (dp[i] - ((i & 2) ? d1 : d0)) * scale;
    uint32_t dsh[C::TS][4], dsl[C::TS][4];
    tf32x3_from_acc(dsh, dsl, dp);

    // dQ (tile) = dS k, k^T from its transposed planes
    float dq_p[DH / 2];
    reg_fence(dsh);
    reg_fence(dsl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::TS; ++kk)
      tf32x3_rs<DH>(dq_p, dsh[kk], dsl[kk], plane_desc<DH>(st + 4 * TP, 0, kk),
                    plane_desc<DH>(st + 5 * TP, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq_p);
    reg_fence(dsh);
    reg_fence(dsl);
    if (lane == 0) mbar_arrive(&empty[b]);  // this warp's products have read the stage
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dq_tot[i] += dq_p[i];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* dst = dq + (row0 + rr + 8 * h) * DH + 2 * t4;
#pragma unroll
    for (int jn = 0; jn < DH / 8; ++jn)
      *reinterpret_cast<float2*>(dst + 8 * jn) =
          make_float2(dq_tot[4 * jn + 2 * h], dq_tot[4 * jn + 2 * h + 1]);
  }
}

// Block b owns the keys (b % (t / BROWS)) * BROWS .. + BROWS - 1 of the
// (batch, head) b / (t / BROWS), 64 for each consumer warpgroup.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1) attention_bwd_dkdv_x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int t,
    float c, float scale) {
  using C = X3<DH, true>;
  constexpr int TILE = C::TILE, TP = C::TILE_PLANE;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* kh = smem;
  uint8_t* kl = kh + C::ROWS_PLANE;
  uint8_t* vh = kl + C::ROWS_PLANE;
  uint8_t* vl = vh + C::ROWS_PLANE;
  uint8_t* stages = smem + C::OFF_STAGE;  // a stage: q, do, q^T, do^T planes (hi, lo); L, D
  uint8_t* raws = smem + C::OFF_RAW;      // a raw tile: q rows, do rows, L, D
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = raw_full + 2;
  uint64_t* empty = full + 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2, wl = warp & 3;
  const int n_blocks = t / BROWS;
  const size_t head = size_t(blockIdx.x / n_blocks) * t;
  const size_t key0 = head + size_t(blockIdx.x % n_blocks) * BROWS;
  const int n_tiles = t / TILE;
  split_bars_init(raw_full, 4 * CONSUMERS);

  if (wg == SPLITTER) {
    regs_dec<WS::PRODUCER>();
    splitter_loop(
        tid - 128 * SPLITTER, BAR_SPLIT, n_tiles, C::RAW, C::STAGE, raws, stages, raw_full, full, empty,
        [&](const float* raw, uint8_t* st, int pt) {
          split_rows<TILE, TILE, DH, 128>(raw, st, st + TP, 0, pt);
          split_rows<TILE, TILE, DH, 128>(raw + TILE * DH, st + 2 * TP, st + 3 * TP, 0, pt);
          split_cols<TILE, DH, 128>(raw, st + 4 * TP, st + 5 * TP, pt);
          split_cols<TILE, DH, 128>(raw + TILE * DH, st + 6 * TP, st + 7 * TP, pt);
          if (pt < 2 * TILE)  // the tile's L and D
            reinterpret_cast<float*>(st + 8 * TP)[pt] = raw[2 * TILE * DH + pt];
        },
        [&](int j) {  // the raw q, do rows, L and D of query tile j
          uint8_t* dst = raws + (j & 1) * C::RAW;
          const size_t r = head + size_t(j) * TILE;
          mbar_expect_tx(&raw_full[j & 1], C::RAW);
          bulk_load(dst, q + r * DH, TP, &raw_full[j & 1]);
          bulk_load(dst + TP, dout + r * DH, TP, &raw_full[j & 1]);
          bulk_load(dst + 2 * TP, lse + r, TILE * 4, &raw_full[j & 1]);
          bulk_load(dst + 2 * TP + TILE * 4, delta + r, TILE * 4, &raw_full[j & 1]);
        });
    return;
  }

  regs_inc<WS::CONSUMER>();
  const int wt = tid & 127, r0 = 64 * wg;
  split_rows<64, BROWS, DH, 128>(k + (key0 + r0) * DH, kh, kl, r0, wt);
  split_rows<64, BROWS, DH, 128>(v + (key0 + r0) * DH, vh, vl, r0, wt);
  fence_proxy_async();
  named_sync(2 + wg, 128);

  float dk_tot[DH / 2], dv_tot[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk_tot[i] = dv_tot[i] = 0.f;

#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    const int b = j & 1;
    mbar_wait(&full[b], (j >> 1) & 1);
    const uint8_t* st = stages + b * C::STAGE;
    const float* ls = reinterpret_cast<const float*>(st + 8 * TP);
    const float* dsum = ls + TILE;

    // S^T = k q^T and dP^T = v do^T: 64 keys x TILE queries
    float s[TILE / 2], dp[TILE / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk)
      tf32x3_ss<TILE>(s, plane_desc<BROWS>(kh, r0, kk), plane_desc<BROWS>(kl, r0, kk),
                      plane_desc<TILE>(st, 0, kk), plane_desc<TILE>(st + TP, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk)
      tf32x3_ss<TILE>(dp, plane_desc<BROWS>(vh, r0, kk), plane_desc<BROWS>(vl, r0, kk),
                      plane_desc<TILE>(st + 2 * TP, 0, kk), plane_desc<TILE>(st + 3 * TP, 0, kk),
                      kk);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // P^T = exp2(S^T c - L) and dS^T = P^T (dP^T - D) scale; element
    // 4 jn + 2 h + e is key r0 + 16 wl + g + 8 h, query 8 jn + 2 t4 + e
#pragma unroll
    for (int jn = 0; jn < TILE / 8; ++jn) {
      const float2 lq = *reinterpret_cast<const float2*>(ls + 8 * jn + 2 * t4);
      const float2 dd = *reinterpret_cast<const float2*>(dsum + 8 * jn + 2 * t4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * jn + 2 * h;
        const float p0 = exp2_approx(fmaf(s[i], c, -lq.x));
        const float p1 = exp2_approx(fmaf(s[i + 1], c, -lq.y));
        s[i] = p0;
        s[i + 1] = p1;
        dp[i] = p0 * (dp[i] - dd.x) * scale;
        dp[i + 1] = p1 * (dp[i + 1] - dd.y) * scale;
      }
    }
    // dV (tile) = P^T do and dK (tile) = dS^T q, do^T and q^T from their
    // transposed planes, in two halves of the tile's queries (HS k8 steps
    // each), so that the split fragments of one half are live at a time
    constexpr int HS = C::TS / 2;
    float dk_p[DH / 2], dv_p[DH / 2];
#pragma unroll
    for (int piece = 0; piece < 2; ++piece) {
      uint32_t ph[HS][4], pl[HS][4], dsh[HS][4], dsl[HS][4];
      tf32x3_from_acc(ph, pl, s, HS * piece);
      tf32x3_from_acc(dsh, dsl, dp, HS * piece);
      reg_fence(ph);
      reg_fence(pl);
      reg_fence(dsh);
      reg_fence(dsl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HS; ++kk) {
        const int ks = HS * piece + kk;  // the k8 step over the tile's queries
        tf32x3_rs<DH>(dv_p, ph[kk], pl[kk], plane_desc<DH>(st + 6 * TP, 0, ks),
                      plane_desc<DH>(st + 7 * TP, 0, ks), ks);
      }
#pragma unroll
      for (int kk = 0; kk < HS; ++kk) {
        const int ks = HS * piece + kk;
        tf32x3_rs<DH>(dk_p, dsh[kk], dsl[kk], plane_desc<DH>(st + 4 * TP, 0, ks),
                      plane_desc<DH>(st + 5 * TP, 0, ks), ks);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dk_p);
      reg_fence(dv_p);
      reg_fence(ph);
      reg_fence(pl);
      reg_fence(dsh);
      reg_fence(dsl);
    }
    if (lane == 0) mbar_arrive(&empty[b]);  // this warp's products have read the stage
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) {
      dk_tot[i] += dk_p[i];
      dv_tot[i] += dv_p[i];
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = key0 + r0 + 16 * wl + g + 8 * h;
#pragma unroll
    for (int jn = 0; jn < DH / 8; ++jn) {
      const int i = 4 * jn + 2 * h;
      *reinterpret_cast<float2*>(dk + row * DH + 8 * jn + 2 * t4) =
          make_float2(dk_tot[i], dk_tot[i + 1]);
      *reinterpret_cast<float2*>(dv + row * DH + 8 * jn + 2 * t4) =
          make_float2(dv_tot[i], dv_tot[i + 1]);
    }
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, const float* o, const float* dout,
           const float* lse, float* delta, float* dq, float* dk, float* dv, int bh, int t,
           float scale, cudaStream_t stream) {
  using CQ = X3<DH, false>;
  using CKV = X3<DH, true>;
  if (t % BROWS != 0 || t % CQ::TILE != 0) return -1;
  static DevicePrep prep_q, prep_kv;
  int sms = 0;
  int prepared = prepare_on_device(prep_q, attention_bwd_dq_x3_kernel<DH>, CQ::SMEM,
                                   WS::MIN_LAUNCH, &sms);
  if (prepared != 0) return prepared;
  prepared = prepare_on_device(prep_kv, attention_bwd_dkdv_x3_kernel<DH>, CKV::SMEM,
                               WS::MIN_LAUNCH, &sms);
  if (prepared != 0) return prepared;
  const float c = scale * 1.4426950408889634f;
  const unsigned blocks = unsigned(bh) * unsigned(t / BROWS);
  attention_bwd_dq_x3_kernel<DH><<<blocks, THREADS, CQ::SMEM, stream>>>(
      q, k, v, o, dout, lse, delta, dq, t, c, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  attention_bwd_dkdv_x3_kernel<DH><<<blocks, THREADS, CKV::SMEM, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, t, c, scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o (the forward's output), dout, dq, dk, dv: contiguous fp32
// (bh, t, dh), 16-byte aligned; lse: the forward's fp32 (bh, t) row
// log-sum-exp (log2 units); delta: fp32 (bh, t) scratch.  Returns 0 on
// success, the cudaError_t of a launch, -1 for a shape the kernels do not
// take, -3 if a kernel was built with too few registers for its setmaxnreg,
// -4 on a device ordinal past MAX_DEVICES.  The kernels launch on the
// host thread's current device.
int s3d_spatial_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, int bh, int t, int dh, float scale,
                                  void* stream) {
  if (bh <= 0 || t <= 0 || static_cast<long long>(bh) * t > 0x7fffffffLL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* g[3] = {static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv)};
  switch (dh) {
    case 24: return launch<24>(qf, kf, vf, of, df, lf, dl, g[0], g[1], g[2], bh, t, scale, s);
    case 48: return launch<48>(qf, kf, vf, of, df, lf, dl, g[0], g[1], g[2], bh, t, scale, s);
    default: return -1;
  }
}

}  // extern "C"
