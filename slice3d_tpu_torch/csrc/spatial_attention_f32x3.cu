// Softmax attention over the LDM UNet's flattened feature maps: forward
// (fp32, 3xTF32 on Hopper's tensor cores).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_attention.py::_attention_forward
// (pallas_call at :59, body _attn_kernel :31) for fp32 inputs, which the JAX
// package sends there at its default precision (the root CLI's LDM computes
// in fp32).  For every (batch, head) of q, k, v (B, H, T, DH):
//
//   out = softmax(q k^T * scale) v
//
// in fp32 in and out.  Both products run on the tensor cores as three TF32
// products of split operands (csrc/attention_sm90.cuh: x = hi + lo, d +=
// lo.hi + hi.lo + hi.hi), which keeps fp32's accuracy where one TF32 product
// (10 bits of mantissa) would not; the online softmax runs in fp32 on the
// CUDA cores.  So the kernel differs from the plain version
// (spatial_attention_ref) by rounding at the fp32 level, summation order and
// the exponential.
//
// What bounds it on the H100: 4 T^2 DH flops per head, as 3 TF32 products
// each on the tensor cores (132 SMs x 2,048 TF32 flops a clock: 535 TFLOP/s
// at 1980 MHz, an fp32 rate of 178 TFLOP/s): 0.58 ms for the ds 1 block (8,
// 8, 4096, 24), 0.072 ms for the ds 2 block (8, 8, 1024, 48); one
// exponential per logit on the special function units (0.26 ms at ds 1);
// q, k, v read and the output written once (101 MB at ds 1: 0.03 ms).
//
// Design: the forward sibling of the backward's dq kernel
// (csrc/spatial_attention_bwd_f32x3.cu), one warp-specialised kernel of
// three warpgroups (384 threads), a block over BQ = 128 queries of one
// (batch, head), one block an SM.  Two consumer warpgroups own 64 queries
// each, split their q rows into hi/lo planes (the A operand of S, K-major
// over the head), and walk over the head's keys in tiles of TILE (128 at DH
// 24, 64 at DH 48):
//   S = q k^T          (SS, DH / 8 k8 steps, k's planes as they lie)
//   online softmax     (fp32 registers: the row max over the quad, one FFMA
//                       and one ex2 a logit, the rescale factor alpha,
//                       exactly 1 while the max stays: softmax_step)
//   P split            (tf32x3_from_acc: S's accumulator is the A fragment)
//   O_tile = P v       (RS, TILE / 8 k8 steps in pieces of 64 keys, v^T's
//                       planes with the keys permuted within each 8 by
//                       kperm, so P's accumulator is the fragment as it lies)
//   O = O alpha + O_tile  on the CUDA cores, once O_tile has completed (an
//                       accumulator read while products are in flight would
//                       make ptxas serialise them)
// The third warpgroup (setmaxnreg 72 against the consumers' 216) streams the
// raw k and v tiles (the rows of one head are contiguous) by 1-D bulk copies
// two tiles ahead and splits each into one of two stages of planes (k as it
// lies, v transposed) while the consumers run their products on the other
// (attention_sm90.cuh's splitter_loop), so a tile is split once for 128
// queries.  At the end O is divided by the row sum l and, when asked (the
// autograd path), the row log-sum-exp is written in log2 units, L = m c +
// log2(l) with c = scale log2(e), which the backward reads.  Overlapping
// the next tile's S with this tile's softmax inside a warpgroup needs both
// S accumulators live beside P's fragments and O: past the consumers' 216
// registers (ptxas spills and serialises the products; slower on the H100).
// Registers and shared memory: 168 registers a thread at launch; dynamic
// shared memory 172,080 B at DH 24, 196,656 B at DH 48.
//
// Only fp32 with T a multiple of BQ and TILE and DH 24 or 48 (the UNet's),
// every tensor 16-byte aligned, is taken; the Python wrapper
// (slice3d_tpu_torch/ops/spatial_attention.py) raises on anything else.
// Plain C interface, built with nvcc into a shared library and bound with
// ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

using namespace s3d_attn;

constexpr int BQ = 128;       // queries of a block, 64 for each consumer warpgroup
constexpr int TILE24 = 128;   // keys of a streamed tile at DH 24
constexpr int TILE48 = 64;    // keys of a streamed tile at DH 48
constexpr int PIECE = 64;     // keys of P v's products at a time (its fragments' registers)
constexpr int CONSUMERS = 2;  // consumer warpgroups
// and the warpgroup that splits the tiles: 168 registers a thread at launch,
// setmaxnreg 72 / 216
using WS = WarpSpecialised<CONSUMERS, 72, 216>;
constexpr int THREADS = WS::THREADS;
constexpr int SPLITTER = CONSUMERS;  // the splitting warpgroup
constexpr int BAR_SPLIT = 1;         // named barriers: 1 the splitter, 2 + w consumer w

// Shared memory (bytes from the start): the block's q rows as hi, lo
// planes; two stages of a tile's planes (k hi, lo; v^T hi, lo); two raw
// tiles (the bulk copies' targets: k rows, v rows); the mbarriers
// raw_full[2], full[2], empty[2].
template <int DH>
struct Fwd {
  static constexpr int TILE = DH == 24 ? TILE24 : TILE48;
  static constexpr int KS = DH / 8;       // k8 steps over the head
  static constexpr int PS = PIECE / 8;    // k8 steps over a piece of the tile
  static constexpr int Q_PLANE = BQ * DH * 4;
  static constexpr int TILE_PLANE = TILE * DH * 4;  // a tile's plane, or its raw rows
  static constexpr int STAGE = 4 * TILE_PLANE;
  static constexpr int RAW = 2 * TILE_PLANE;
  static constexpr int OFF_STAGE = 2 * Q_PLANE;
  static constexpr int OFF_RAW = OFF_STAGE + 2 * STAGE;
  static constexpr int OFF_BAR = OFF_RAW + 2 * RAW;
  static constexpr int SMEM = OFF_BAR + 6 * 8;
  static_assert(SMEM <= 232448, "shared memory over the per-block limit");
  static_assert(BQ % TILE == 0 && TILE % PIECE == 0, "whole tiles a head, whole pieces a tile");
};

// One online-softmax step over N keys of raw logits s (this thread's rows
// h = 0, 1: element 4 j + 2 h + e), as attention_sm90.cuh's
// online_softmax_step but with the rescale factor alpha = exp2((m_old - m)
// c), exactly 1 while the row max stays: exp2(fmaf(m_old, c, -m c)) is
// 2^(m c - fl(m c)) there, a factor of up to ~1 + 3e-6 that every later tile
// would apply to the running sum again (~1e-4 of the log-sum-exp over 64
// tiles).  The logits' exp2(s c - fl(m c)) share one such factor while the
// max stays, which L = fl(m c) + log2(l) takes back out.  Leaves the
// probabilities in s.
template <int N>
__device__ __forceinline__ void softmax_step(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[h] = exp2_approx((m[h] - mx) * c);  // 0 on the first step (m = -inf)
    m[h] = mx;
    const float neg_mc = -mx * c;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      float& a = s[4 * j + 2 * h];
      float& b = s[4 * j + 2 * h + 1];
      a = exp2_approx(fmaf(a, c, neg_mc));
      b = exp2_approx(fmaf(b, c, neg_mc));
      sum += a + b;
    }
    l[h] = fmaf(l[h], alpha[h], sum);
  }
}

// Block b owns the queries (b % (t / BQ)) * BQ .. + BQ - 1 of the (batch,
// head) b / (t / BQ), so neighbouring blocks share their K/V in L2.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    attention_fwd_x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out,
                            float* __restrict__ lse, int t, float c) {
  using C = Fwd<DH>;
  constexpr int TILE = C::TILE, TP = C::TILE_PLANE;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* qh = smem;
  uint8_t* ql = qh + C::Q_PLANE;
  uint8_t* stages = smem + C::OFF_STAGE;  // a stage: k, v^T planes (hi, lo)
  uint8_t* raws = smem + C::OFF_RAW;      // a raw tile: k rows, v rows
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = raw_full + 2;
  uint64_t* empty = full + 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2, wl = warp & 3;
  const int n_blocks = t / BQ;
  const size_t head = size_t(blockIdx.x / n_blocks) * t;
  const size_t row0 = head + size_t(blockIdx.x % n_blocks) * BQ;
  const int n_tiles = t / TILE;
  split_bars_init(raw_full, 4 * CONSUMERS);

  if (wg == SPLITTER) {
    regs_dec<WS::PRODUCER>();
    splitter_loop(
        tid - 128 * SPLITTER, BAR_SPLIT, n_tiles, C::RAW, C::STAGE, raws, stages, raw_full,
        full, empty,
        [&](const float* raw, uint8_t* st, int pt) {
          split_rows<TILE, TILE, DH, 128>(raw, st, st + TP, 0, pt);
          split_cols<TILE, DH, 128>(raw + TILE * DH, st + 2 * TP, st + 3 * TP, pt);
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
  const int r0 = 64 * wg;
  split_rows<64, BQ, DH, 128>(q + (row0 + r0) * DH, qh, ql, r0, tid & 127);
  fence_proxy_async();
  named_sync(2 + wg, 128);

  // this thread's rows r0 + 16 wl + g (h = 0) and + 8 (h = 1): element
  // 4 j + 2 h + e of an accumulator is row h, column 8 j + 2 t4 + e
  float o[DH / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;

#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    const int b = j & 1;
    mbar_wait(&full[b], (j >> 1) & 1);
    const uint8_t* st = stages + b * C::STAGE;

    // S = q k^T: 64 queries x TILE keys
    float s[TILE / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk)
      tf32x3_ss<TILE>(s, plane_desc<BQ>(qh, r0, kk), plane_desc<BQ>(ql, r0, kk),
                      plane_desc<TILE>(st, 0, kk), plane_desc<TILE>(st + TP, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    float alpha[2];
    softmax_step<TILE>(s, m, l, alpha, c);

    // O (tile) = P v, v^T from its transposed planes, a piece of PIECE keys
    // at a time (the split fragments of one piece are live at a time)
    float op[DH / 2];
#pragma unroll
    for (int piece = 0; piece < TILE / PIECE; ++piece) {
      uint32_t ph[C::PS][4], pl[C::PS][4];
      tf32x3_from_acc(ph, pl, s, C::PS * piece);
      reg_fence(ph);
      reg_fence(pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::PS; ++kk) {
        const int ks = C::PS * piece + kk;  // the k8 step over the tile's keys
        tf32x3_rs<DH>(op, ph[kk], pl[kk], plane_desc<DH>(st + 2 * TP, 0, ks),
                      plane_desc<DH>(st + 3 * TP, 0, ks), ks);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(op);
      reg_fence(ph);
      reg_fence(pl);
    }
    if (lane == 0) mbar_arrive(&empty[b]);  // this warp's products have read the stage
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], op[i]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / sum;
    const size_t row = row0 + r0 + 16 * wl + g + 8 * h;
    float* dst = out + row * DH + 2 * t4;
#pragma unroll
    for (int jn = 0; jn < DH / 8; ++jn)
      *reinterpret_cast<float2*>(dst + 8 * jn) =
          make_float2(o[4 * jn + 2 * h] * inv, o[4 * jn + 2 * h + 1] * inv);
    if (lse != nullptr && t4 == 0) lse[row] = m[h] * c + log2f(sum);
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, float* out, float* lse, int bh,
           int t, float scale, cudaStream_t stream) {
  using C = Fwd<DH>;
  const long long blocks = static_cast<long long>(bh) * (t / BQ);
  if (blocks > 0x7fffffffLL) return -1;
  static DevicePrep prep;
  int sms = 0;
  const int prepared = prepare_on_device(prep, attention_fwd_x3_kernel<DH>, C::SMEM,
                                         WS::MIN_LAUNCH, &sms);
  if (prepared != 0) return prepared;
  attention_fwd_x3_kernel<DH><<<unsigned(blocks), THREADS, C::SMEM, stream>>>(
      q, k, v, out, lse, t, scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, out: contiguous fp32 (bh, t, dh), 16-byte aligned; lse: fp32
// (bh, t) or null (the rows' log-sum-exp of S * scale in log2 units, written
// only when given).  Returns 0 on success, the cudaError_t of the launch, -1
// for a shape the kernel does not take, -3 if the kernel was built with too
// few registers for its setmaxnreg, -4 on a device ordinal past
// MAX_DEVICES.  The kernel launches on the host thread's current device.
int s3d_spatial_attention_f32(const void* q, const void* k, const void* v, void* out,
                              void* lse, int bh, int t, int dh, float scale, void* stream) {
  if (bh <= 0 || t <= 0 || t % BQ != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);
  switch (dh) {
    case 24: return launch<24>(qf, kf, vf, of, lf, bh, t, scale, s);
    case 48: return launch<48>(qf, kf, vf, of, lf, bh, t, scale, s);
    default: return -1;
  }
}

}  // extern "C"
