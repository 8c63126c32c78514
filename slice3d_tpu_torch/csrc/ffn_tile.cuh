// The F-tile loop of the SDF head's 128 -> F -> 128 ReLU FFN on Hopper
// (sm_90a, bf16), shared by csrc/fused_encoder.cu (the FFN half of the whole
// encoder layer) and csrc/fused_ffn.cu (the FFN alone), so that the two
// kernels' arithmetic is one code.  Built from csrc/attention_sm90.cuh's
// pieces (mbarriers that trap, TMA, wgmma, setmaxnreg, tensor maps).
//
// Shape of both kernels: persistent, warp-specialised blocks, one an SM, of
// consumer warpgroups of 64 rows each (two in the encoder layer, three in
// fused_ffn) and one producer warpgroup.  A block walks over row tiles.  One
// thread of the producer streams the weights through a ring of STAGES stages
// of 32 KB (a W1 F-tile and a W2 F-tile, or a whole 128 x 128 projection of
// the encoder) by TMA, in TMA's 128-byte swizzle, which is the layout a
// K-major wgmma operand reads.  The weights are the same for every row tile,
// so the ring walks the same sequence of stages tile after tile without
// draining.
//
// Per F-tile of FT = 64 columns of the hidden layer, a consumer warpgroup
//   GEMM 1:  hid (64 x 64, fp32)   = h (64 x 128, shared) W1-tile^T   (SS)
//            relu(hid + b1), rounded to bf16 in registers
//   GEMM 2:  out (64 x 128, fp32) += relu-tile (registers) W2-tile^T   (RS)
// so the (rows, F) activation never leaves the SM.  W1 (F, 128) and W2 (128,
// F) are K-major as nn.Linear stores them.  Registers a consumer thread:
// out 64, hid 32, the bf16 tile 16.
//
// Weight bytes from L2: every block reads all the weights once a row tile,
// 4 * 128 * F bytes (1 MB at F = 2048), a count worked out from the tiling
// (no L2 counter was read).  Two ways to read fewer were built and timed on
// the H100 (PERF.md): more rows a tile (three consumer warpgroups, 192 rows:
// fused_ffn takes it; the encoder's buffers leave no room for it), and
// clusters of 2 blocks that each loaded half of every stage and multicast
// it to both (half the bytes a row, but a stage was refilled only when the
// consumers of both blocks were done with it, and both kernels read slower
// with it: neither keeps it).
// Issuing GEMM 1 of the next F-tile before this one's epilogue (two hid
// tiles) made ptxas serialise the products (C7515) and read slower; the
// warpgroups' epilogues hide under each other's products instead.

#pragma once

#include "attention_sm90.cuh"

namespace s3d {

using namespace s3d_attn;

constexpr int D = 128;                    // model width (FFN input and output)
constexpr int FT = 64;                    // FFN F-tile: F must be a multiple of it
constexpr int STAGES = 3;                 // weight ring depth
constexpr int STAGE_BYTES = 2 * D * D;    // one stage: W1 tile + W2 tile, or one D x D weight
constexpr int W1_TILE_BYTES = FT * D * 2; // the W1 tile's part of an FFN stage
constexpr int ROWS = 128;                 // rows of a tile of two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_WARP = 8;          // the first warp of the producer warpgroup
using WS = WarpSpecialised<2, 40, 232>;   // 168 registers a thread at launch

// Byte offset of element (r, c) of a swizzled (rows, 128) bf16 tile: two
// halves of 64 columns, each `rows` rows of 128 bytes in TMA's 128-byte
// swizzle (the 16-byte chunk c / 8 of row r sits at chunk (c / 8) ^ (r % 8)).
// Such a tile starts at a 1024-byte boundary and rows is a multiple of 8.
__device__ __forceinline__ uint32_t sw128(int rows, int r, int c) {
  return uint32_t((c >> 6) * rows * 128 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
                  (c & 7) * 2);
}

// Descriptor of the k16 step kk (0..7) of rows r0 .. of such a tile as a
// K-major wgmma operand (r0 a multiple of 8).
__device__ __forceinline__ uint64_t sw128_desc(const uint8_t* tile, int rows, int r0, int kk) {
  return smem_desc(tile + (kk >> 2) * rows * 128 + r0 * 128 + (kk & 3) * 32, 16, 1024, SW128);
}

// The weight ring: stage s of stream index `it` is it % STAGES; `full`
// completes when its bytes have landed, `empty` when the block's WARPS
// consumer warps are done with it.
template <int WARPS = CONSUMER_WARPS>
struct Ring {
  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;

  __device__ void init() {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
  }
  // consumer: the stage of stream index it, once it has landed
  __device__ const uint8_t* acquire(int it) const {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    return stages + s * STAGE_BYTES;
  }
  // the stage of stream index it (one that has landed)
  __device__ const uint8_t* stage_at(int it) const { return stages + (it % STAGES) * STAGE_BYTES; }
  // consumer warp (after its products that read the stage have completed)
  __device__ void release(int it, int lane) const {
    if (lane == 0) mbar_arrive(&empty[it % STAGES]);
  }
  // producer: wait until the stage of stream index it is free, arm it for
  // its STAGE_BYTES and return it
  __device__ uint8_t* arm(int it) const {
    const int s = it % STAGES;
    if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[s], STAGE_BYTES);
    return stages + s * STAGE_BYTES;
  }
  // producer: one box of a stage
  __device__ void load(uint8_t* dst, const CUtensorMap* map, int it, int c0, int c1) const {
    tma_load_2d(dst, map, &full[it % STAGES], c0, c1);
  }
  // producer: F-tile j of W1 (boxes of 64 rows) and W2 (boxes of 128 rows)
  __device__ void load_ffn(const CUtensorMap* w1, const CUtensorMap* w2, int it, int j) const {
    uint8_t* st = arm(it);
    load(st, w1, it, 0, j * FT);
    load(st + W1_TILE_BYTES / 2, w1, it, 64, j * FT);
    load(st + W1_TILE_BYTES, w2, it, j * FT, 0);
  }
  // producer: rows r0 .. r0 + 127 of a (., 128) weight (boxes of 128 rows)
  __device__ void load_square(const CUtensorMap* w, int it, int r0) const {
    uint8_t* st = arm(it);
    load(st, w, it, 0, r0);
    load(st + STAGE_BYTES / 2, w, it, 64, r0);
  }
};

// The products of one F-tile for a consumer warpgroup (rows r0 .. r0 + 63 of
// the swizzled h tile of h_rows rows), each its own commit group:
// GEMM 1, hid = h W1-tile^T (SS) ...
__device__ __forceinline__ void issue_gemm1(float (&hid)[32], const uint8_t* h, int h_rows,
                                            int r0, const uint8_t* st) {
  reg_fence(hid);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss<64, 0, 0>(hid, sw128_desc(h, h_rows, r0, kk), sw128_desc(st, FT, 0, kk), kk);
  wgmma_commit();
  reg_fence(hid);
}

// ... and, after relu(hid + b1) -> bf16 A fragments a (hid is only read:
// an instruction other than wgmma that writes an accumulator makes ptxas
// serialise the warpgroup's products), GEMM 2, out += a W2-tile^T (RS).
__device__ __forceinline__ void relu_gemm2(float (&out)[64], const float (&hid)[32],
                                           uint32_t (&a)[4][4], const uint8_t* st,
                                           const float* __restrict__ b1, int lane) {
  const float* bj = b1 + 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float2 b0 = __ldg(reinterpret_cast<const float2*>(bj + 16 * kk));
    const float2 b8 = __ldg(reinterpret_cast<const float2*>(bj + 16 * kk + 8));
    const float* d = hid + 8 * kk;  // columns 16 kk + 2 t (+ 1), then + 8
    a[kk][0] = pack_bf16(fmaxf(d[0] + b0.x, 0.f), fmaxf(d[1] + b0.y, 0.f));
    a[kk][1] = pack_bf16(fmaxf(d[2] + b0.x, 0.f), fmaxf(d[3] + b0.y, 0.f));
    a[kk][2] = pack_bf16(fmaxf(d[4] + b8.x, 0.f), fmaxf(d[5] + b8.y, 0.f));
    a[kk][3] = pack_bf16(fmaxf(d[6] + b8.x, 0.f), fmaxf(d[7] + b8.y, 0.f));
  }
  reg_fence(a);
  reg_fence(out);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<128, 0>(out, a[kk], smem_desc(st + W1_TILE_BYTES + kk * 32, 16, 1024, SW128));
  wgmma_commit();
  reg_fence(out);
  reg_fence(a);
}

// out (64 x 128, fp32) = relu(H W1^T + b1) W2^T for the consumer warpgroup
// whose rows are r0 .. r0 + 63 of the swizzled h tile (h_rows rows), over
// all F / FT stages of the ring from stream index it on (advanced past
// them).  The caller has made the h rows visible to the async proxy.
// Rounds relu(.) to bf16 as the plain version does.  GEMM 2 of one F-tile
// runs under the wait for GEMM 1 of the next; a warpgroup's epilogue hides
// under the other warpgroups' products.
template <typename R>
__device__ __forceinline__ void ffn_accumulate(float (&out)[64], const uint8_t* h, int h_rows,
                                               int r0, const R& ring, int& it,
                                               const float* __restrict__ b1, int f, int lane) {
  const int n_tiles = f / FT;
  float hid[32];
  uint32_t a[4][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) out[i] = 0.f;
#pragma unroll 1
  for (int s = 0; s < n_tiles; ++s, ++it) {
    issue_gemm1(hid, h, h_rows, r0, ring.acquire(it));
    wgmma_wait<0>();  // GEMM 1 of this tile and GEMM 2 of the last
    reg_fence(hid);
    reg_fence(out);
    reg_fence(a);
    if (s > 0) ring.release(it - 1, lane);
    relu_gemm2(out, hid, a, ring.stage_at(it), b1 + s * FT, lane);
  }
  wgmma_wait<0>();
  reg_fence(out);
  ring.release(it - 1, lane);
}

// LayerNorm (eps 1e-5, fp32) of the rows of an m64n128 accumulator: this
// thread holds columns 8 j + 2 t + e of rows g (v[4 j + e]) and g + 8
// (v[4 j + 2 + e]); a row spans a lane quad.
__device__ __forceinline__ void layer_norm_rows(float (&v)[64], const float* __restrict__ gamma,
                                                const float* __restrict__ beta, int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) s += v[4 * j + 2 * hh] + v[4 * j + 2 * hh + 1];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mu = s * (1.f / D);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float d0 = v[4 * j + 2 * hh] - mu, d1 = v[4 * j + 2 * hh + 1] - mu;
      q += d0 * d0 + d1 * d1;
    }
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    const float rs = rsqrtf(q * (1.f / D) + 1e-5f);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 gg = __ldg(reinterpret_cast<const float2*>(gamma + c));
      const float2 bb = __ldg(reinterpret_cast<const float2*>(beta + c));
      v[4 * j + 2 * hh] = (v[4 * j + 2 * hh] - mu) * rs * gg.x + bb.x;
      v[4 * j + 2 * hh + 1] = (v[4 * j + 2 * hh + 1] - mu) * rs * gg.y + bb.y;
    }
  }
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// Rows g and g + 8 (of warp wl's 16) of an m64n128 accumulator as bf16 into
// a swizzled (rows, 128) tile at tile row r0 + 16 wl.
__device__ __forceinline__ void store_rows_sw128(uint8_t* tile, int rows, int r0,
                                                 const float (&v)[64], int wl, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 16 * wl + g + 8 * hh;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(tile + sw128(rows, r, 8 * j + 2 * t4)) =
          pack_bf16(v[4 * j + 2 * hh], v[4 * j + 2 * hh + 1]);
  }
}

}  // namespace s3d
