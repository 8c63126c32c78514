// The F-tile loop of the SDF head's 128 -> F -> 128 ReLU FFN in fp32 on
// Hopper's tensor cores (sm_90a, 3xTF32), and the weight ring it reads,
// used by csrc/fused_ffn_f32x3.cu and csrc/fused_encoder_f32x3.cu (the
// encoder layer's FFN half; its attention kernel streams Wqkv through a ring
// of its own item size).  Built from csrc/attention_sm90.cuh's pieces
// (mbarriers that trap, bulk copies, the TF32 split, planes and wgmma
// products).
//
// fp32 in, fp32 out: every product is three TF32 products of split operands
// (x = hi + lo, d += lo.hi + hi.lo + hi.hi; attention_sm90.cuh), which keeps
// fp32's accuracy where one TF32 product would not.  Within an F-tile the
// tensor cores sum in their fp32 accumulator (K = 128 for GEMM 1, FT for
// GEMM 2); the output's sum over the F-tiles runs in fp32 on the CUDA cores.
//
// Shape: a block of two consumer warpgroups of 64 rows each and one producer
// warpgroup (one thread of which streams the weights; setmaxnreg gives the
// consumers its registers) walks over tiles of ROWS = 128 rows.  Each
// consumer warpgroup splits its rows of x into hi and lo planes (K-major
// over D, 64 KB each for the block's 128 rows).  Per F-tile of FT = 32
// hidden units a warpgroup runs
//   GEMM 1:  hid (64 x FT)  = x W1-tile^T              (SS, 16 k8 steps)
//            relu(hid + b1), split into TF32 A fragments in registers
//   GEMM 2:  part (64 x 128) = relu-tile W2-tile^T     (RS, FT / 8 k8 steps)
//            out += part (CUDA cores), when GEMM 2 has completed
// so the (rows, F) activation never leaves the SM.  The accumulator of GEMM
// 1 is the A fragment of GEMM 2 as it lies, because W2's F index is permuted
// within each 8 at packing time (kperm, attention_sm90.cuh).  GEMM 2 of one
// F-tile runs under GEMM 1 of the next, and the two warpgroups' products
// under each other's epilogues.
//
// Weights: the wrapper packs each weight set once (ops/prepared.py,
// ops/fused_ffn.py::ffn_stream_f32x3; the encoder layer puts Wo's items
// ahead of them, ops/fused_encoder.py::_pack_f32) into the stream of items
// the ring reads, per F-tile a W1 item then a W2 item, each its hi plane then its lo
// plane in the layout wgmma reads (32 KB an item at FT = 32): W1's rows are
// hidden units, W2's rows the 128 outputs.  The producer copies an item with
// one 1-D bulk copy into a ring of STAGES slots; a slot is refilled when the
// eight consumer warps have released it.  Every block reads all the
// weights, hi and lo (4 MB at F = 2048), once a 128-row tile, from L2.
//
// Registers of a consumer thread: out 64, part 64, hid FT / 2, the split
// fragments FT.

#pragma once

#include "attention_sm90.cuh"

namespace s3d_x3 {

using namespace s3d_attn;

constexpr int D = 128;      // model width (FFN input and output)
constexpr int FT = 32;      // F-tile: F must be a multiple of it
constexpr int ROWS = 128;   // rows of a block's tile, 64 a consumer warpgroup
constexpr int STAGES = 3;   // ring slots
constexpr int CONSUMER_WARPS = 8;
constexpr int PLANE_BYTES = FT * D * 4;      // a TF32 plane of a W1 or W2 F-tile
constexpr int ITEM_BYTES = 2 * PLANE_BYTES;  // an item of the stream: hi, then lo
constexpr int X_PLANE_BYTES = ROWS * D * 4;  // a TF32 plane of the tile's x rows

// A weight ring of S slots of ITEM bytes: item `it` of the stream sits in
// slot it % S; `full` completes when its bytes have landed, `empty` when
// the consumer warps are done with it.
template <int S, int ITEM>
struct RingOf {
  static constexpr int SLOTS = S;
  static constexpr int ITEM_SIZE = ITEM;
  uint8_t* slots;
  uint64_t* full;
  uint64_t* empty;

  __device__ void init() const {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
  }
  // consumer: item it, once it has landed
  __device__ const uint8_t* acquire(int it) const {
    const int s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    return slots + s * ITEM;
  }
  // consumer warp, after its products that read item it have completed
  __device__ void release(int it, int lane) const {
    if (lane == 0) mbar_arrive(&empty[it % S]);
  }
  // producer: copy item it of the stream from src once its slot is free
  __device__ void load(int it, const uint8_t* src) const {
    const int s = it % S;
    if (it >= S) mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
    mbar_expect_tx(&full[s], ITEM);
    bulk_load(slots + s * ITEM, src, ITEM, &full[s]);
  }
};

// The FFN's ring: W1 and W2 items of an F-tile (and, in the encoder layer,
// Wo's items before them).
using Ring = RingOf<STAGES, ITEM_BYTES>;

// Rows row0 .. row0 + 63 of x (n rows of D fp32, 16-byte aligned) into plane
// rows r0 .. r0 + 63 of the x planes (rows past n as zeros, which compute
// values never stored); wt: the thread's index in its warpgroup.
__device__ __forceinline__ void split_x_rows(uint8_t* xh, uint8_t* xl, int r0,
                                             const float* __restrict__ x, int row0, int n,
                                             int wt) {
  constexpr int NCH = D / 4;
#pragma unroll
  for (int k = 0; k < 64 * NCH / 128; ++k) {
    const int i = wt + 128 * k;
    const int rest = i >> 3, c = rest % NCH, r = (rest / NCH) * 8 + (i & 7);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) v = __ldg(reinterpret_cast<const float4*>(x + size_t(row0 + r) * D) + c);
    const uint32_t off = plane_offset<ROWS>(r0 + r, 4 * c);
    tf32_split_store4(xh + off, xl + off, v);
  }
}

// out (64 x 128, fp32) = relu(x W1^T + b1) W2^T for the consumer warpgroup
// whose rows are r0 .. r0 + 63 of the x planes, over the f / FT F-tiles of
// the ring from item `it` on (advanced past them).  The caller has made the
// x planes visible to the async proxy.
__device__ __forceinline__ void ffn_rows(float (&out)[64], const uint8_t* xh, const uint8_t* xl,
                                         int r0, const Ring& ring, int& it,
                                         const float* __restrict__ b1, int f, int lane) {
  const int n_ft = f / FT;
  float part[64], hid[FT / 2], h[FT / 2];
  uint32_t ah[FT / 8][4], al[FT / 8][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) out[i] = 0.f;
#pragma unroll 1
  for (int s = 0; s < n_ft; ++s, it += 2) {
    const uint8_t* w1 = ring.acquire(it);
    reg_fence(hid);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      tf32x3_ss<FT>(hid, plane_desc<ROWS>(xh, r0, kk), plane_desc<ROWS>(xl, r0, kk),
                    plane_desc<FT>(w1, 0, kk), plane_desc<FT>(w1 + PLANE_BYTES, 0, kk), kk);
    wgmma_commit();
    reg_fence(hid);
    if (s > 0) {  // GEMM 2 of the last F-tile has completed: free its W2 item
      wgmma_wait<1>();
      ring.release(it - 1, lane);
    }
    wgmma_wait<0>();
    reg_fence(hid);
    reg_fence(part);
    ring.release(it, lane);
    // the last F-tile's partial, read once no product is in flight (a read
    // of an accumulator while one is makes ptxas serialise the products)
    if (s > 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) out[i] += part[i];
    }

    // relu(hid + b1): element 4 j + 2 hh + e is column 8 j + 2 t + e
    const float* bj = b1 + s * FT + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < FT / 8; ++j) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(bj + 8 * j));
      h[4 * j + 0] = fmaxf(hid[4 * j + 0] + b.x, 0.f);
      h[4 * j + 1] = fmaxf(hid[4 * j + 1] + b.y, 0.f);
      h[4 * j + 2] = fmaxf(hid[4 * j + 2] + b.x, 0.f);
      h[4 * j + 3] = fmaxf(hid[4 * j + 3] + b.y, 0.f);
    }
    tf32x3_from_acc(ah, al, h);

    const uint8_t* w2 = ring.acquire(it + 1);
    reg_fence(ah);
    reg_fence(al);
    reg_fence(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FT / 8; ++kk)
      tf32x3_rs<D>(part, ah[kk], al[kk], plane_desc<D>(w2, 0, kk),
                   plane_desc<D>(w2 + PLANE_BYTES, 0, kk), kk);
    wgmma_commit();
    reg_fence(part);
    reg_fence(ah);
    reg_fence(al);
  }
  wgmma_wait<0>();
  reg_fence(part);
  ring.release(it - 1, lane);
#pragma unroll
  for (int i = 0; i < 64; ++i) out[i] += part[i];
}

}  // namespace s3d_x3
