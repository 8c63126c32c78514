// Fused post-LN transformer encoder layer for the SDF head (inference, fp32,
// 3xTF32 on Hopper's tensor cores, sm_90a).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_encoder.py::fused_encoder_layer
// (pallas_call at :463, and :522 for kernel_variant="perhead"; bodies
// _layer_kernel_bdq :269, _layer_kernel_v2 :188, _layer_kernel_grouped :104
// and _layer_kernel :42) for fp32 inputs, which the JAX package sends there
// at --dtype float32 (slice3d_tpu/models/build.py:19-21: compute dtype None,
// fused_ffn on; :36-39 of the kernel size its fp32 blocks).  For every query
// point, over its T <= 16 tokens of width 128:
//
//   qkv  = x Wqkv^T + bqkv
//   per head h (4 heads of 32): o_h = softmax(q_h k_h^T / sqrt(32)) v_h
//   h1   = LN1(x + o Wo^T + bo)                          (eps 1e-5)
//   out  = LN2(h1 + relu(h1 W1^T + b1) W2^T + b2)
//
// with `head_tokens = 1` keeping only token 0 after attention (k and v still
// run over every token).  fp32 in, fp32 out: every product with a weight
// runs on the tensor cores as three TF32 products of split operands
// (csrc/attention_sm90.cuh: x = hi + lo, d += lo.hi + hi.lo + hi.hi), which
// keeps fp32's accuracy where one TF32 product would not; the T x T core,
// the softmax (expf), the LayerNorms and every sum across tiles run in fp32
// on the CUDA cores.  Every rounding point of the TPU kernel is the identity
// in fp32, so the kernel differs from the plain version
// (fused_encoder_layer_ref) by rounding at the fp32 level, summation order
// and the exponential.  The TPU kernel pads 13 tokens to 16 and masks the
// pad keys with -1e9, whose exponential is exactly 0 in fp32: looping over
// the T real keys is the same function, and no pad rows are kept.
//
// What bounds it on the H100: ~15.4 MFLOP a point (88% of it the
// 128 -> 2048 -> 128 FFN) against ~13 KB of activations in and out, as
// three TF32 products each on the tensor cores (132 SMs x 2,048 TF32 flops a
// clock: 535 TFLOP/s at 1980 MHz, an fp32 rate of 178 TFLOP/s): 2.92 ms at
// N = 33,800 points of 13 tokens, 0.37 ms with head_tokens = 1 (k and v
// over 13 tokens, the rest over one).
//
// Design: two persistent warp-specialised kernels, one block an SM, of two
// consumer warpgroups (64 rows each, setmaxnreg 232) and one producer
// warpgroup, one thread of which streams the weights' hi/lo TF32 planes
// (packed once a weight set by the wrapper, ops/fused_encoder.py::_pack_f32)
// by 1-D bulk copies through a ring of slots on mbarriers; one launch after
// the other on the caller's stream:
//   attention (attn_x3_kernel): a tile takes P = 128 / T whole points (9 at
//     T = 13: 117 of 128 rows); the consumers split its x rows into hi/lo
//     planes, and per head run q|k|v (64 x 96 a warpgroup) = x Wh^T as SS
//     products, Wh's planes arriving in 8 items of 16 K-columns (12 KB) through
//     a 4-slot ring.  With head_tokens = 1 q runs over every row as well
//     (one product shape for the tile; 13% of the trimmed layer's flops).
//     q|k|v + bias go to shared memory (points straddle the two warpgroups'
//     rows), then the T x T core runs as in the TPU kernel, a pair of
//     threads a query (16 dims each, one shuffle a logit), fp32 softmax
//     with expf, and the head's 32 columns of o go to a scratch (N * T_out,
//     128) fp32 in device memory.  The core is ~0.6% of the flops; it runs
//     between the head's products, the tensor cores idle.
//   the rest (post_x3_kernel): a tile takes 128 rows of o (every row a
//     token that goes on); the consumers split them into the x planes and
//     run o Wo^T as SS products (64 x 128 a warpgroup, Wo's planes as the
//     stream's 4 leading items of 32 K-columns), add bo and the x residual,
//     and LayerNorm 1 on the accumulator fragments (a row's 128 columns lie
//     in one quad of lanes: two shuffles a sum); h1 is split into the x
//     planes, over o, and the FFN runs as csrc/ffn_tile_f32x3.cuh's F-tile
//     loop (ffn_rows) on the same ring.  LayerNorm 2's residual h1 is rebuilt
//     from its planes as hi + lo, within 2^-22 |h1| of it (no register or
//     shared memory is left to keep it in fp32: the planes and the ring take
//     224 KB, ffn_rows 232 registers a thread).
// Splitting the layer at o costs o's round trip through device memory
// (225 MB at N = 33,800, T = 13: ~0.13 ms at 3.35 TB/s) and buys an FFN over
// dense 128-row tiles, where one kernel over whole points would run 9% of
// its FFN on spare rows; the 4-head projection and the core run on the
// 117-row tiles, ~9% of the work.  Weight bytes from L2: Wqkv's planes
// (384 KB) a point tile, Wo's, W1's and W2's (4.3 MB) a row tile.  Dynamic
// shared memory: 231,488 B (attention: the x planes, q|k|v, the ring),
// 229,424 B (the rest: the x planes, the ring).  Registers (ptxas -v,
// sm_90a): 168 a thread at launch; the rest spills 16 bytes.
//
// Only fp32 x is taken, with D 128, 4 heads, 1 <= T <= 16, F a positive
// multiple of 32 and head_tokens 0 or 1, every tensor 16-byte aligned; the
// Python wrapper (slice3d_tpu_torch/ops/fused_encoder.py) raises on anything
// else.  Plain C interface, built with nvcc into a shared library and bound
// with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ffn_tile_f32x3.cuh"

namespace {

using namespace s3d_x3;

constexpr int NH = 4;        // heads
constexpr int DH = 32;       // head width
constexpr int MAX_T = 16;    // tokens a point
constexpr int QKV = 3 * DH;  // a head's q|k|v columns
constexpr int KC = 16;       // K columns of an attention weight item
constexpr int ATTN_STAGES = 4;
constexpr int ATTN_PLANE = QKV * KC * 4;   // a TF32 plane of an attention item
constexpr int ATTN_ITEMS = NH * (D / KC);  // a tile's items: per head, per K chunk
constexpr int LDQ = QKV + 4;  // row stride (floats) of q|k|v in shared memory
constexpr int WO_ITEMS = D / FT;  // Wo's items ahead of the FFN's, FT K-columns each
using AttnRing = RingOf<ATTN_STAGES, 2 * ATTN_PLANE>;

constexpr int CONSUMERS = 2;  // consumer warpgroups of 64 rows
// and one producer warpgroup: 168 registers a thread at launch, setmaxnreg
// 40 / 232
using WS = WarpSpecialised<CONSUMERS, 40, 232>;
constexpr int THREADS = WS::THREADS;
constexpr int BAR_CONSUMERS = 3;  // named barriers: 1 + w consumer warpgroup w, 3 both

constexpr int ATTN_OFF_QKV = 2 * X_PLANE_BYTES;
constexpr int ATTN_OFF_RING = ATTN_OFF_QKV + ROWS * LDQ * 4;
constexpr int ATTN_OFF_BAR = ATTN_OFF_RING + ATTN_STAGES * 2 * ATTN_PLANE;
constexpr int ATTN_SMEM = ATTN_OFF_BAR + 2 * ATTN_STAGES * 8;
constexpr int POST_OFF_RING = 2 * X_PLANE_BYTES;
constexpr int POST_OFF_BAR = POST_OFF_RING + STAGES * ITEM_BYTES;
constexpr int POST_SMEM = POST_OFF_BAR + 2 * STAGES * 8;
static_assert(ATTN_SMEM <= 232448 && POST_SMEM <= 232448,
              "shared memory over the per-block limit");
static_assert(NH * DH == D && D % KC == 0 && D % FT == 0, "heads and items tile the width");
static_assert(CONSUMER_WARPS == 4 * CONSUMERS, "the rings count every consumer warp");

// The producer warpgroup: one thread streams n_items items of the packed
// stream w (ITEM bytes each) a tile, for the block's tiles.
template <class R>
__device__ __forceinline__ void stream_items(const R& ring, const uint8_t* __restrict__ w,
                                             int n_items, int n_tiles) {
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
    for (int i = 0; i < n_items; ++i, ++it) ring.load(it, w + size_t(i) * R::ITEM_SIZE);
}

// acc (64 x N, fp32) = A B^T for the consumer warpgroup whose rows are r0 ..
// r0 + 63 of the x planes, over K_ITEMS items of the ring from `it` on
// (advanced past them), each K_STEPS k8 steps of B's hi and lo planes of N
// rows; B's item i covers the contraction's columns 8 K_STEPS i ...  Each
// item is released once the products that read it have completed.
template <int N, int K_ITEMS, int K_STEPS, class R>
__device__ __forceinline__ void project(float (&acc)[N / 2], const uint8_t* xh,
                                        const uint8_t* xl, int r0, const R& ring, int& it,
                                        int lane) {
  constexpr int PLANE = R::ITEM_SIZE / 2;
#pragma unroll 1
  for (int i = 0; i < K_ITEMS; ++i, ++it) {
    const uint8_t* b = ring.acquire(it);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K_STEPS; ++kk) {
      const int ks = i * K_STEPS + kk;  // the k8 step over x's columns
      tf32x3_ss<N>(acc, plane_desc<ROWS>(xh, r0, ks), plane_desc<ROWS>(xl, r0, ks),
                   plane_desc<N>(b, 0, kk), plane_desc<N>(b + PLANE, 0, kk), ks);
    }
    wgmma_commit();
    reg_fence(acc);
    if (i > 0) {  // the last item's products have completed
      wgmma_wait<1>();
      ring.release(it - 1, lane);
    }
  }
  wgmma_wait<0>();
  reg_fence(acc);
  ring.release(it - 1, lane);
}

// Block b: the tiles b, b + gridDim.x, ... of P = ROWS / t points of x (n,
// t, D); w: the attention stream (per head, per K chunk of KC: Wh's 96 rows
// of q, k, v as a hi and a lo plane); bqkv (3 D): q, k, v biases; o: (n * t,
// D), or (n, D) with HEAD1 (token 0 only), fp32.
template <bool HEAD1>
__global__ void __launch_bounds__(THREADS, 1)
    attn_x3_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ bqkv, float* __restrict__ o, int n, int t,
                   float scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* xh = smem;
  uint8_t* xl = smem + X_PLANE_BYTES;
  float* Q = reinterpret_cast<float*>(smem + ATTN_OFF_QKV);  // a head's q | k | v (ROWS, LDQ)
  AttnRing ring;
  ring.slots = smem + ATTN_OFF_RING;
  ring.full = reinterpret_cast<uint64_t*>(smem + ATTN_OFF_BAR);
  ring.empty = ring.full + ATTN_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_tile = ROWS / t;
  const int n_tiles = (n + per_tile - 1) / per_tile;
  if (tid == 0) {
    ring.init();
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    regs_dec<WS::PRODUCER>();
    if (warp == CONSUMER_WARPS && lane == 0) stream_items(ring, w, ATTN_ITEMS, n_tiles);
    return;
  }

  regs_inc<WS::CONSUMER>();
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int r0 = 64 * wg;
  // the core's query: a pair of threads a query row, DH / 2 dims each;
  // threads past the queries compute query 0 again and store nothing, so
  // every lane takes part in the shuffles
  const int qi = tid / 2, part = tid % 2;
  int it = 0;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * per_tile;
    const int pts = min(per_tile, n - p0);
    const int rows = pts * t;
    named_sync(1 + wg, 128);  // the warpgroup's products of the last tile have read x
    split_x_rows(xh, xl, r0, x + size_t(p0) * t * D, r0, rows, tid & 127);
    fence_proxy_async();
    named_sync(1 + wg, 128);

    const int queries = HEAD1 ? pts : rows;
    const bool store = qi < queries;
    const int qr = store ? qi : 0;
    const int qrow = HEAD1 ? qr * t : qr;           // its row in the tile
    const int key0 = HEAD1 ? qr * t : qr - qr % t;  // its point's first row
    float* dst = o + (size_t(HEAD1 ? p0 : size_t(p0) * t) + qr) * D + part * (DH / 2);

#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      float acc[QKV / 2];  // q|k|v of head h: the warpgroup's 64 rows x 96
      project<QKV, D / KC, KC / 8>(acc, xh, xl, r0, ring, it, lane);
      named_sync(BAR_CONSUMERS, 256);  // the last head's core has read q|k|v
      // + bias into Q: element 4 j + 2 hh + e is row r0 + 16 wl + g + 8 hh,
      // column 8 j + 2 t4 + e (which = column / DH: 0 q, 1 k, 2 v)
#pragma unroll
      for (int j = 0; j < QKV / 8; ++j) {
        const int c = 8 * j + 2 * t4;
        const float2 bb =
            __ldg(reinterpret_cast<const float2*>(bqkv + (c / DH) * D + h * DH + c % DH));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(Q + (r0 + 16 * wl + g + 8 * hh) * LDQ + c) =
              make_float2(acc[4 * j + 2 * hh] + bb.x, acc[4 * j + 2 * hh + 1] + bb.y);
      }
      named_sync(BAR_CONSUMERS, 256);  // Q holds the tile's q|k|v of head h

      // the core: logits over the point's t keys, softmax, o = P V
      float q[DH / 2];
      const float* qp = Q + qrow * LDQ + part * (DH / 2);
#pragma unroll
      for (int d = 0; d < DH / 2; d += 4) {
        const float4 v = *reinterpret_cast<const float4*>(qp + d);
        q[d] = v.x, q[d + 1] = v.y, q[d + 2] = v.z, q[d + 3] = v.w;
      }
      float s[MAX_T];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < MAX_T; ++j) {
        if (j < t) {  // t is the block's: every lane takes the same branch
          const float* kp = Q + (key0 + j) * LDQ + DH + part * (DH / 2);
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DH / 2; d += 4) {
            const float4 v = *reinterpret_cast<const float4*>(kp + d);
            dot = fmaf(q[d], v.x, dot);
            dot = fmaf(q[d + 1], v.y, dot);
            dot = fmaf(q[d + 2], v.z, dot);
            dot = fmaf(q[d + 3], v.w, dot);
          }
          s[j] = (dot + __shfl_xor_sync(0xffffffffu, dot, 1)) * scale;
          mx = fmaxf(mx, s[j]);
        }
      }
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_T; ++j)
        if (j < t) {
          s[j] = expf(s[j] - mx);
          l += s[j];
        }
      float av[DH / 2];
#pragma unroll
      for (int d = 0; d < DH / 2; ++d) av[d] = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_T; ++j) {
        if (j < t) {
          const float p = s[j] / l;
          const float* vp = Q + (key0 + j) * LDQ + 2 * DH + part * (DH / 2);
#pragma unroll
          for (int d = 0; d < DH / 2; d += 4) {
            const float4 v = *reinterpret_cast<const float4*>(vp + d);
            av[d] = fmaf(p, v.x, av[d]);
            av[d + 1] = fmaf(p, v.y, av[d + 1]);
            av[d + 2] = fmaf(p, v.z, av[d + 2]);
            av[d + 3] = fmaf(p, v.w, av[d + 3]);
          }
        }
      }
      if (store) {
#pragma unroll
        for (int d = 0; d < DH / 2; d += 4)
          *reinterpret_cast<float4*>(dst + h * DH + d) =
              make_float4(av[d], av[d + 1], av[d + 2], av[d + 3]);
      }
    }
  }
}

// LayerNorm (eps 1e-5) of the two rows this thread holds of a 64 x 128
// accumulator: element 4 j + 2 hh + e is row hh, column 8 j + 2 t4 + e, so a
// row's 128 columns lie in the quad of lanes t4 = 0 .. 3.
__device__ __forceinline__ void layer_norm_rows(float (&v)[64], const float* __restrict__ ln_w,
                                                const float* __restrict__ ln_b, int t4) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) s += v[4 * j + 2 * hh] + v[4 * j + 2 * hh + 1];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mu = s / float(D);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float a = v[4 * j + 2 * hh] - mu, b = v[4 * j + 2 * hh + 1] - mu;
      q = fmaf(a, a, q);
      q = fmaf(b, b, q);
    }
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    const float r = rsqrtf(q / float(D) + 1e-5f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 gg = __ldg(reinterpret_cast<const float2*>(ln_w + c));
      const float2 bb = __ldg(reinterpret_cast<const float2*>(ln_b + c));
      float& a = v[4 * j + 2 * hh];
      float& b = v[4 * j + 2 * hh + 1];
      a = (a - mu) * r * gg.x + bb.x;
      b = (b - mu) * r * gg.y + bb.y;
    }
  }
}

// Block b: the 128-row tiles b, b + gridDim.x, ... of o (n_rows, D), 64 rows
// a consumer warpgroup, and of the residual x (row r at x + r * x_ld) ->
// out (n_rows, D); w: the packed stream of Wo's WO_ITEMS items, then the
// FFN's 2 f / FT.
__global__ void __launch_bounds__(THREADS, 1)
    post_x3_kernel(const float* __restrict__ o, const float* __restrict__ x, int x_ld,
                   const uint8_t* __restrict__ w, const float* __restrict__ bo,
                   const float* __restrict__ g1, const float* __restrict__ be1,
                   const float* __restrict__ b1, const float* __restrict__ b2,
                   const float* __restrict__ g2, const float* __restrict__ be2,
                   float* __restrict__ out, int n_rows, int f) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* xh = smem;
  uint8_t* xl = smem + X_PLANE_BYTES;
  Ring ring;
  ring.slots = smem + POST_OFF_RING;
  ring.full = reinterpret_cast<uint64_t*>(smem + POST_OFF_BAR);
  ring.empty = ring.full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_items = WO_ITEMS + 2 * (f / FT);
  const int n_tiles = (n_rows + ROWS - 1) / ROWS;
  if (tid == 0) {
    ring.init();
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    regs_dec<WS::PRODUCER>();
    if (warp == CONSUMER_WARPS && lane == 0) stream_items(ring, w, n_items, n_tiles);
    return;
  }

  regs_inc<WS::CONSUMER>();
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int r0 = 64 * wg;
  int it = 0;
  float acc[64];
#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS + r0;
    if (row0 >= n_rows) {  // no rows for this warpgroup: keep the ring in step
#pragma unroll 1
      for (int i = 0; i < n_items; ++i, ++it) {
        ring.acquire(it);
        ring.release(it, lane);
      }
      continue;
    }
    named_sync(1 + wg, 128);  // the warpgroup is done with the last tile's planes
    split_x_rows(xh, xl, r0, o, row0, n_rows, tid & 127);
    fence_proxy_async();
    named_sync(1 + wg, 128);

    // o Wo^T + bo + x, LayerNorm 1: rows g and g + 8 of this warp's 16
    project<D, WO_ITEMS, FT / 8>(acc, xh, xl, r0, ring, it, lane);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 16 * wl + g + 8 * hh;
      const float* xr = x + size_t(row < n_rows ? row : row0) * x_ld + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 res = __ldg(reinterpret_cast<const float2*>(xr + 8 * j));
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bo + 8 * j + 2 * t4));
        acc[4 * j + 2 * hh] = res.x + (acc[4 * j + 2 * hh] + bb.x);
        acc[4 * j + 2 * hh + 1] = res.y + (acc[4 * j + 2 * hh + 1] + bb.y);
      }
    }
    layer_norm_rows(acc, g1, be1, t4);

    // h1 into the x planes, over o (every warp's products have read o)
    named_sync(1 + wg, 128);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 16 * wl + g + 8 * hh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const uint32_t off = plane_offset<ROWS>(r, 8 * j + 2 * t4);
        uint2 hi, lo;
        tf32_split(acc[4 * j + 2 * hh], hi.x, lo.x);
        tf32_split(acc[4 * j + 2 * hh + 1], hi.y, lo.y);
        *reinterpret_cast<uint2*>(xh + off) = hi;
        *reinterpret_cast<uint2*>(xl + off) = lo;
      }
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);

    // the FFN, + b2 + h1 (rebuilt from its planes), LayerNorm 2
    ffn_rows(acc, xh, xl, r0, ring, it, b1, f, lane);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 16 * wl + g + 8 * hh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const uint32_t off = plane_offset<ROWS>(r, 8 * j + 2 * t4);
        const uint2 hi = *reinterpret_cast<const uint2*>(xh + off);
        const uint2 lo = *reinterpret_cast<const uint2*>(xl + off);
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + 8 * j + 2 * t4));
        acc[4 * j + 2 * hh] =
            (__uint_as_float(hi.x) + __uint_as_float(lo.x)) + (acc[4 * j + 2 * hh] + bb.x);
        acc[4 * j + 2 * hh + 1] =
            (__uint_as_float(hi.y) + __uint_as_float(lo.y)) + (acc[4 * j + 2 * hh + 1] + bb.y);
      }
    }
    layer_norm_rows(acc, g2, be2, t4);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 16 * wl + g + 8 * hh;
      if (row >= n_rows) continue;
      float* dst = out + size_t(row) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

template <bool HEAD1>
int launch_attn(const float* x, const uint8_t* w, const float* bqkv, float* o, int n, int t,
                cudaStream_t stream) {
  static DevicePrep prep;
  int sms = 0;
  const int prepared =
      prepare_on_device(prep, attn_x3_kernel<HEAD1>, ATTN_SMEM, WS::MIN_LAUNCH, &sms);
  if (prepared != 0) return prepared;
  const int per_tile = ROWS / t;
  const int n_tiles = (n + per_tile - 1) / per_tile;
  attn_x3_kernel<HEAD1><<<n_tiles < sms ? n_tiles : sms, THREADS, ATTN_SMEM, stream>>>(
      x, w, bqkv, o, n, t, float(1.0 / sqrt(double(DH))));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks of each kernel that an SM holds at once: the attention kernel's
// (head_tokens 0 or 1) and the rest's.  Returns 0 or a cudaError_t.
int s3d_fused_encoder_f32_blocks_per_sm(int head_tokens, int* attn, int* post) {
  const int e = head_tokens ? resident_blocks(attn_x3_kernel<true>, THREADS, ATTN_SMEM, attn)
                            : resident_blocks(attn_x3_kernel<false>, THREADS, ATTN_SMEM, attn);
  return e != 0 ? e : resident_blocks(post_x3_kernel, THREADS, POST_SMEM, post);
}

// x: contiguous fp32 (n, t, 128); wqkv: the packed attention stream (4 heads
// x 8 items of a head's 96 q|k|v rows over 16 K-columns, each a hi and a lo
// TF32 plane); wpost: the packed Wo (4 items of its 128 rows over 32
// K-columns) then the FFN's 2 f / 32 items (ops/fused_ffn.py::ffn_stream_f32x3);
// bqkv (384), bo, g1, be1, b1 (f), b2, g2, be2 fp32; o: fp32 scratch of
// (n * t_out, 128) and out: fp32 (n, t_out, 128), t_out = head_tokens ? 1 :
// t; every pointer 16-byte aligned.  Launches the attention kernel and then
// the rest on `stream`.  Returns 0 on success, the cudaError_t of a launch,
// -1 for a shape the kernels do not take, -3 if a kernel was built with too
// few registers for its setmaxnreg, -4 on a device ordinal past
// MAX_DEVICES.  The kernels launch on the host thread's current device.
int s3d_fused_encoder_f32(const void* x, const void* wqkv, const void* wpost, const void* bqkv,
                          const void* bo, const void* g1, const void* be1, const void* b1,
                          const void* b2, const void* g2, const void* be2, void* o, void* out,
                          int n, int t, int f, int head_tokens, void* stream) {
  if (n <= 0) return 0;
  if (t < 1 || t > MAX_T || f <= 0 || f % FT || (head_tokens != 0 && head_tokens != 1))
    return -1;
  const long long n_rows = head_tokens ? n : static_cast<long long>(n) * t;
  if (n_rows > 0x7fffffffLL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* wa = static_cast<const uint8_t*>(wqkv);
  const float* bq = static_cast<const float*>(bqkv);
  float* of = static_cast<float*>(o);
  int rc = head_tokens ? launch_attn<true>(xf, wa, bq, of, n, t, s)
                       : launch_attn<false>(xf, wa, bq, of, n, t, s);
  if (rc != 0) return rc;
  static DevicePrep prep;
  int sms = 0;
  rc = prepare_on_device(prep, post_x3_kernel, POST_SMEM, WS::MIN_LAUNCH, &sms);
  if (rc != 0) return rc;
  const long long n_tiles = (n_rows + ROWS - 1) / ROWS;
  post_x3_kernel<<<unsigned(n_tiles < sms ? n_tiles : sms), THREADS, POST_SMEM, s>>>(
      of, xf, head_tokens ? t * D : D, static_cast<const uint8_t*>(wpost),
      static_cast<const float*>(bo), static_cast<const float*>(g1),
      static_cast<const float*>(be1), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(g2),
      static_cast<const float*>(be2), static_cast<float*>(out), int(n_rows), f);
  return int(cudaGetLastError());
}

}  // extern "C"
