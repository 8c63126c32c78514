// Fused post-LN transformer encoder layer for the SDF head (inference, fp32, sm_90a).
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
// run over every token).  True fp32: every product and sum is an fp32 FMA
// on the CUDA cores (no TF32, no bf16), and every rounding point of the TPU
// kernel is the identity in fp32, so the kernel differs from the plain
// version (fused_encoder_layer_ref) by summation order and the exponential
// alone.  The TPU kernel pads 13 tokens to 16 and masks the pad keys with
// -1e9, whose exponential is exactly 0 in fp32: looping over the T real keys
// is the same function, and no pad rows are kept.
//
// What bounds it on the H100: ~15.4 MFLOP a point (88% of it the
// 128 -> 2048 -> 128 FFN) against ~13 KB of activations in and out: the fp32
// FMA rate, 66.9 TFLOP/s at 132 SMs x 128 lanes x 2 x 1980 MHz: 7.79 ms at
// N = 33,800 points of 13 tokens, 1.00 ms with head_tokens = 1 (k and v
// over 13 tokens, the rest over one).
//
// Design: two plain SIMT kernels of 256 threads on csrc/ffn_tile_f32.cuh's
// register-blocked products (8 x NC outputs a thread), one launch after the
// other on the caller's stream:
//   attention (attn_f32_kernel): a block takes P = 128 / T whole points
//     (9 at T = 13, 117 of 128 rows), their x in shared memory, and walks
//     the 4 heads; a head's Wq, Wk, Wv columns arrive as one [128][96]
//     stage through a 2-slot cp.async ring.  Per head: q|k (8 x 4 a
//     thread) and v (8 x 2) over the tile into shared memory (with
//     head_tokens = 1: k|v over every row, and q for token 0 alone as
//     plain dot products spread over the block), then the T x T core, a
//     pair of threads a query (16 dims each, one shuffle a logit), fp32
//     softmax with expf, and the head's 32 columns of o written to a scratch
//     (N * T_out, 128) fp32 in device memory.  Shared memory: x (67,584 B),
//     q/k/v (51,200 B), the ring (98,304 B).
//   the rest (post_f32_kernel): a block takes 128 rows of o (every row is
//     a token that goes on: no spare rows), o Wo^T (8 x 8 a thread, Wo^T in
//     two [64][128] stages) + bo + the x residual (read from device memory,
//     token 0's rows with head_tokens = 1), LN1 in registers (a row's 128
//     columns lie in 16 lanes: shuffles), h1 into shared memory over o, the
//     FFN's F-tile loop (ffn_tile), LN2, out.  Shared memory: 200,704 B.
// Splitting the layer at o costs o's round trip through device memory
// (225 MB at N = 33,800, T = 13: ~0.13 ms at 3.35 TB/s, 2% of the bound)
// and buys an FFN over dense 128-row tiles, where one kernel over whole
// points would run 9% of its FFN on spare rows; the 4-head projection and
// the core run on the 117-row tiles, ~9% of the work.  Weight bytes from
// L2: 192 KB of Wqkv a point tile, 2.1 MB of Wo, W1 and W2 a row tile,
// counted from the tiling.  One block an SM (shared memory); the blocks
// are not persistent.
//
// Only fp32 x is taken, with D 128, 4 heads, 1 <= T <= 16, F a positive
// multiple of 64 and head_tokens 0 or 1, every tensor 16-byte aligned; the
// Python wrapper (slice3d_tpu_torch/ops/fused_encoder.py) raises on anything
// else.  Plain C interface, built with nvcc into a shared library and bound
// with ctypes.

#include "ffn_tile_f32.cuh"

namespace {

using namespace s3d_f32;

constexpr int NH = 4;       // heads
constexpr int DH = 32;      // head width
constexpr int MAX_T = 16;   // tokens a point
constexpr int QKV = 3 * DH;       // a head's q|k|v columns: one attention stage is [D][QKV]
constexpr int LDQ = QKV + 4;      // row stride of the head's q|k|v in shared memory
constexpr int ATTN_STAGE = D * QKV;
constexpr int ATTN_SMEM = (ROWS * LDX + ROWS * LDQ + 2 * ATTN_STAGE) * 4;
constexpr int POST_SMEM = (ROWS * LDX + ROWS * LDH + STAGES * FFN_STAGE) * 4;
static_assert(ATTN_SMEM <= 232448 && POST_SMEM <= 232448,
              "shared memory over the per-block limit");
static_assert(NH * DH == D, "heads tile the width");

// Block b: points b * P .. of x (n, t, D), P = ROWS / t; wqkv: NH stages
// [D][QKV] (head h's Wq, Wk, Wv columns); bqkv (3 D): q, k, v biases; o:
// (n * t, D), or (n, D) with HEAD1 (token 0 only), fp32.
template <bool HEAD1>
__global__ void __launch_bounds__(THREADS, 1)
    attn_f32_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                    const float* __restrict__ bqkv, float* __restrict__ o, int n, int t,
                    float scale) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;
  float* Q = X + ROWS * LDX;  // a head's q | k | v, row-major (ROWS, LDQ)
  float* W = Q + ROWS * LDQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int per_tile = ROWS / t;
  const int p0 = blockIdx.x * per_tile;
  const int pts = min(per_tile, n - p0);
  const int rows = pts * t;

  load_rows(X, x + size_t(p0) * t * D, D, rows);
  Ring<2, ATTN_STAGE> ring;
  ring.init(W, wqkv, NH);

  // the core's query: a pair of threads a query row, DH / 2 dims each;
  // threads past the queries compute query 0 again and store nothing, so
  // every lane takes part in the shuffles
  const int queries = HEAD1 ? pts : rows;
  const int qi = threadIdx.x / 2, part = threadIdx.x % 2;
  const bool store = qi < queries;
  const int qr = store ? qi : 0;
  const int qrow = HEAD1 ? qr * t : qr;        // its row in the tile
  const int key0 = HEAD1 ? qr * t : qr - qr % t;  // its point's first row
  float* dst = o + (size_t(HEAD1 ? p0 : size_t(p0) * t) + qr) * D + part * (DH / 2);

#pragma unroll 1
  for (int h = 0; h < NH; ++h) {
    const float* w = ring.next();
    // projections: stage column sc = which * DH + c (which 0 q, 1 k, 2 v)
    {
      constexpr int C0 = HEAD1 ? DH : 0;  // q|k, or k|v with HEAD1
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
      gemm<4, D>(a, X, LDX, w + C0, QKV, ty, tx);
      float bias[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sc = C0 + tile_col<4>(tx, j);
        bias[j] = bqkv[(sc / DH) * D + h * DH + sc % DH];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(Q + tile_row(ty, i) * LDQ + C0 + tile_col<4>(tx, 0)) =
            make_float4(a[i][0] + bias[0], a[i][1] + bias[1], a[i][2] + bias[2],
                        a[i][3] + bias[3]);
    }
    if (!HEAD1) {  // v
      float a[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i][0] = a[i][1] = 0.f;
      gemm<2, D>(a, X, LDX, w + 2 * DH, QKV, ty, tx);
      const int c = tile_col<2>(tx, 0);
      const float b0 = bqkv[2 * D + h * DH + c], b1 = bqkv[2 * D + h * DH + c + 1];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float2*>(Q + tile_row(ty, i) * LDQ + 2 * DH + c) =
            make_float2(a[i][0] + b0, a[i][1] + b1);
    } else {  // q of token 0, a dot product of 128 a (point, dim)
      for (int e = threadIdx.x; e < pts * DH; e += THREADS) {
        const int p = e / DH, c = e % DH;
        const float* xr = X + p * t * LDX;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 8
        for (int k = 0; k < D; k += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + k);
          s0 = fmaf(xv.x, w[(k + 0) * QKV + c], s0);
          s1 = fmaf(xv.y, w[(k + 1) * QKV + c], s1);
          s2 = fmaf(xv.z, w[(k + 2) * QKV + c], s2);
          s3 = fmaf(xv.w, w[(k + 3) * QKV + c], s3);
        }
        Q[p * t * LDQ + c] = ((s0 + s1) + (s2 + s3)) + bqkv[h * DH + c];
      }
    }
    __syncthreads();

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
    float acc[DH / 2];
#pragma unroll
    for (int d = 0; d < DH / 2; ++d) acc[d] = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_T; ++j) {
      if (j < t) {
        const float p = s[j] / l;
        const float* vp = Q + (key0 + j) * LDQ + 2 * DH + part * (DH / 2);
#pragma unroll
        for (int d = 0; d < DH / 2; d += 4) {
          const float4 v = *reinterpret_cast<const float4*>(vp + d);
          acc[d] = fmaf(p, v.x, acc[d]);
          acc[d + 1] = fmaf(p, v.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, v.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, v.w, acc[d + 3]);
        }
      }
    }
    if (store) {
#pragma unroll
      for (int d = 0; d < DH / 2; d += 4)
        *reinterpret_cast<float4*>(dst + h * DH + d) =
            make_float4(acc[d], acc[d + 1], acc[d + 2], acc[d + 3]);
    }
    // the next head's ring.next() meets the block before q|k|v is rewritten
  }
}

// Block b: rows b * ROWS .. of o (n_rows, D) and of the residual x (row r
// at x + r * x_ld) -> out (n_rows, D); w: the packed stream of Wo^T (two
// [64][D] stages) and the FFN's 2 f / FT stages.
__global__ void __launch_bounds__(THREADS, 1)
    post_f32_kernel(const float* __restrict__ o, const float* __restrict__ x, int x_ld,
                    const float* __restrict__ w, const float* __restrict__ bo,
                    const float* __restrict__ g1, const float* __restrict__ be1,
                    const float* __restrict__ b1, const float* __restrict__ b2,
                    const float* __restrict__ g2, const float* __restrict__ be2,
                    float* __restrict__ out, int n_rows, int f) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;
  float* H = X + ROWS * LDX;
  float* W = H + ROWS * LDH;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, n_rows - row0);

  load_rows(X, o + size_t(row0) * D, D, rows);
  FfnRing ring;
  ring.init(W, w, 2 + 2 * (f / FT));

  float v[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
  gemm<8, D / 2>(v, X, LDX, ring.next(), D, ty, tx);          // o[:, :64] Wo^T[:64]
  gemm<8, D / 2>(v, X + D / 2, LDX, ring.next(), D, ty, tx);  // o[:, 64:] Wo^T[64:]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_row(ty, i);
    const float* xr = x + size_t(row0 + (r < rows ? r : 0)) * x_ld;
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      const int c = tile_col<8>(tx, j);
      const float4 res = r < rows ? *reinterpret_cast<const float4*>(xr + c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      v[i][j] = res.x + (v[i][j] + bo[c]);
      v[i][j + 1] = res.y + (v[i][j + 1] + bo[c + 1]);
      v[i][j + 2] = res.z + (v[i][j + 2] + bo[c + 2]);
      v[i][j + 3] = res.w + (v[i][j + 3] + bo[c + 3]);
    }
  }
  layer_norm(v, g1, be1, tx);
  __syncthreads();  // every thread is done reading o: h1 goes over it
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* hr = X + tile_row(ty, i) * LDX;
    *reinterpret_cast<float4*>(hr + tile_col<8>(tx, 0)) =
        make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    *reinterpret_cast<float4*>(hr + tile_col<8>(tx, 4)) =
        make_float4(v[i][4], v[i][5], v[i][6], v[i][7]);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
  ffn_tile(v, X, H, ring, b1, f, ty, tx);  // its first ring.next() meets the block: h1 is whole
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float* hr = X + tile_row(ty, i) * LDX;  // this thread's own h1 values
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col<8>(tx, j);
      v[i][j] = hr[c] + (v[i][j] + b2[c]);
    }
  }
  layer_norm(v, g2, be2, tx);
  store_rows(out + size_t(row0) * D, v, rows, ty, tx);
}

template <bool HEAD1>
int launch_attn(const float* x, const float* wqkv, const float* bqkv, float* o, int n, int t,
                cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(attn_f32_kernel<HEAD1>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, ATTN_SMEM);
  if (e != cudaSuccess) return int(e);
  const int per_tile = ROWS / t;
  attn_f32_kernel<HEAD1><<<(n + per_tile - 1) / per_tile, THREADS, ATTN_SMEM, stream>>>(
      x, wqkv, bqkv, o, n, t, float(1.0 / sqrt(double(DH))));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks of each kernel that an SM holds at once: the attention kernel's
// (head_tokens 0 or 1) and the rest's.  Returns 0 or a cudaError_t.
int s3d_fused_encoder_f32_blocks_per_sm(int head_tokens, int* attn, int* post) {
  const int e = head_tokens ? resident_blocks(attn_f32_kernel<true>, ATTN_SMEM, attn)
                            : resident_blocks(attn_f32_kernel<false>, ATTN_SMEM, attn);
  return e != 0 ? e : resident_blocks(post_f32_kernel, POST_SMEM, post);
}

// x: contiguous fp32 (n, t, 128); wqkv: the packed Wqkv (4 stages of
// [128][96]); wpost: the packed Wo^T (two [64][128] stages) then the FFN's
// 2 f / 64 stages; bqkv (384), bo, g1, be1, b1 (f), b2, g2, be2 fp32; o: fp32
// scratch of (n * t_out, 128) and out: fp32 (n, t_out, 128), t_out =
// head_tokens ? 1 : t; every pointer 16-byte aligned.  Launches the
// attention kernel and then the rest on `stream`.  Returns 0 on success,
// the cudaError_t of a launch, or -1 for a shape the kernels do not take.
// The kernels launch on the host thread's current device.
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
  float* of = static_cast<float*>(o);
  int rc = head_tokens
               ? launch_attn<true>(xf, static_cast<const float*>(wqkv),
                                   static_cast<const float*>(bqkv), of, n, t, s)
               : launch_attn<false>(xf, static_cast<const float*>(wqkv),
                                    static_cast<const float*>(bqkv), of, n, t, s);
  if (rc != 0) return rc;
  cudaError_t e =
      cudaFuncSetAttribute(post_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, POST_SMEM);
  if (e != cudaSuccess) return int(e);
  post_f32_kernel<<<unsigned((n_rows + ROWS - 1) / ROWS), THREADS, POST_SMEM, s>>>(
      of, xf, head_tokens ? t * D : D, static_cast<const float*>(wpost),
      static_cast<const float*>(bo), static_cast<const float*>(g1),
      static_cast<const float*>(be1), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(g2),
      static_cast<const float*>(be2), static_cast<float*>(out), int(n_rows), f);
  return int(cudaGetLastError());
}

}  // extern "C"
