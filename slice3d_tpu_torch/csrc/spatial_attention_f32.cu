// Softmax attention over the LDM UNet's flattened feature maps (forward, fp32).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_attention.py::_attention_forward
// (pallas_call at :59, body _attn_kernel) for fp32 inputs, which the JAX
// package sends there at its default precision (the root CLI's LDM computes
// in fp32).  For every (batch, head) of q, k, v (B, H, T, DH):
//
//   out = softmax(q k^T * scale) v
//
// in true fp32: every product and sum is an fp32 FMA on the CUDA cores (no
// TF32, no bf16), so in fp32, where each rounding point of the TPU kernel is
// the identity, the kernel differs from the plain version
// (spatial_attention_ref) by summation order and the exponential alone.
//
// What bounds it on the H100: 4 T^2 DH flops per head as fp32 FMAs, 66.9
// TFLOP/s at 132 SMs x 128 lanes x 2 x 1980 MHz: 1.54 ms for the ds 1 block
// (8, 8, 4096, 24) and 0.19 ms for the ds 2 block (8, 8, 1024, 48).  One
// exponential per logit on the special function units (16 a clock an SM) is
// a sixth of that at DH 24, and q, k, v read and the output written once
// (101 MB at ds 1: 0.03 ms at 3.35 TB/s) a fiftieth.  A 3xTF32 design on
// the tensor cores would lift the FMA bound (later work: ROADMAP.md).
//
// Design (one plain SIMT kernel): a block takes BQ query rows of one
// (batch, head); each thread holds ROWS of those rows in registers, PART
// head dims of each (DH 24: one thread a row; DH 48: a pair of lanes a row,
// which add their halves of each logit with one shuffle), with its fp32
// output accumulator, running max and running sum.  K and V pass through
// shared memory in tiles of BK keys; every thread reads each staged element
// as a broadcast and uses it for each of its ROWS rows.  The online softmax
// runs KC keys at a time: KC logits, the new max, one rescale of the
// accumulator, then exp2(s c - m c) with c = scale log2(e) (one FFMA and one
// ex2 a logit; scale > 0, so the max of the raw logits is the max of the
// scaled ones) and O += P V.  The output is divided by the row sum at the
// end.  When asked (the autograd path) the row's log-sum-exp is written in
// log2 units, L = m c + log2(l), as the bf16 forward writes it, for the fp32
// backward (csrc/spatial_attention_bwd_f32.cu).
//
// Only fp32 q/k/v are taken, with T a multiple of BQ and BK and DH 24 or 48
// (the UNet's), every tensor 16-byte aligned; the Python wrapper
// (slice3d_tpu_torch/ops/spatial_attention.py) raises on anything else.  Plain
// C interface, built with nvcc into a shared library and bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;   // query rows per block
constexpr int BK = 64;    // keys per K/V tile in shared memory
constexpr int KC = 16;    // keys per online-softmax update
constexpr int ROWS = 2;   // query rows a thread holds
constexpr int PART = 24;  // head dims a thread holds of each row

template <int DH>
struct Fwd {
  static constexpr int SPLIT = DH / PART;               // threads a row: 1 or 2
  static constexpr int THREADS = BQ / ROWS * SPLIT;     // 64 or 128
  static constexpr int STRIDE = BQ / ROWS;              // a thread's rows r0, r0 + STRIDE
  static_assert(DH % PART == 0 && (SPLIT == 1 || SPLIT == 2), "DH 24 or 48");
};

__device__ __forceinline__ void fma4(float (&acc)[PART], int i, float a, const float4 x) {
  acc[4 * i + 0] = fmaf(a, x.x, acc[4 * i + 0]);
  acc[4 * i + 1] = fmaf(a, x.y, acc[4 * i + 1]);
  acc[4 * i + 2] = fmaf(a, x.z, acc[4 * i + 2]);
  acc[4 * i + 3] = fmaf(a, x.w, acc[4 * i + 3]);
}

__device__ __forceinline__ float dot4(const float (&a)[PART], int i, const float4 x, float s) {
  s = fmaf(a[4 * i + 0], x.x, s);
  s = fmaf(a[4 * i + 1], x.y, s);
  s = fmaf(a[4 * i + 2], x.z, s);
  return fmaf(a[4 * i + 3], x.w, s);
}

// Block b takes the query rows (b % (t / BQ)) * BQ .. + BQ - 1 of the
// (batch, head) b / (t / BQ), so neighbouring blocks share their K/V in L2.
template <int DH>
__global__ void __launch_bounds__(Fwd<DH>::THREADS) attention_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int t, float c) {
  using C = Fwd<DH>;
  __shared__ __align__(16) float ks[BK * DH];
  __shared__ __align__(16) float vs[BK * DH];

  const int tid = threadIdx.x;
  const int off = (tid % C::SPLIT) * PART;  // this thread's dims of its rows
  const int r0 = tid / C::SPLIT;
  const int n_qblocks = t / BQ;
  const int bh = blockIdx.x / n_qblocks;
  const int q0 = (blockIdx.x % n_qblocks) * BQ;
  const size_t head = size_t(bh) * t;  // the head's first row

  float qr[ROWS][PART], o[ROWS][PART], m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float4* src = reinterpret_cast<const float4*>(
        q + (head + q0 + r0 + r * C::STRIDE) * DH + off);
#pragma unroll
    for (int i = 0; i < PART / 4; ++i) {
      const float4 x = src[i];
      qr[r][4 * i + 0] = x.x;
      qr[r][4 * i + 1] = x.y;
      qr[r][4 * i + 2] = x.z;
      qr[r][4 * i + 3] = x.w;
    }
#pragma unroll
    for (int d = 0; d < PART; ++d) o[r][d] = 0.f;
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

#pragma unroll 1
  for (int j0 = 0; j0 < t; j0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    const float4* ksrc = reinterpret_cast<const float4*>(k + (head + j0) * DH);
    const float4* vsrc = reinterpret_cast<const float4*>(v + (head + j0) * DH);
    for (int i = tid; i < BK * DH / 4; i += C::THREADS) {
      reinterpret_cast<float4*>(ks)[i] = ksrc[i];
      reinterpret_cast<float4*>(vs)[i] = vsrc[i];
    }
    __syncthreads();

#pragma unroll 1
    for (int jc = 0; jc < BK; jc += KC) {
      float s[ROWS][KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(ks + (jc + j) * DH + off);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) s[r][j] = 0.f;
#pragma unroll
        for (int i = 0; i < PART / 4; ++i) {
          const float4 x = kr[i];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) s[r][j] = dot4(qr[r], i, x, s[r][j]);
        }
        if (C::SPLIT == 2) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) s[r][j] += __shfl_xor_sync(0xffffffffu, s[r][j], 1);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < KC; ++j) mx = fmaxf(mx, s[r][j]);
        const float alpha = exp2f((m[r] - mx) * c);  // 0 on the first chunk (m = -inf)
        const float mc = mx * c;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          s[r][j] = exp2f(fmaf(s[r][j], c, -mc));
          sum += s[r][j];
        }
        l[r] = fmaf(l[r], alpha, sum);
        m[r] = mx;
#pragma unroll
        for (int d = 0; d < PART; ++d) o[r][d] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float4* vr = reinterpret_cast<const float4*>(vs + (jc + j) * DH + off);
#pragma unroll
        for (int i = 0; i < PART / 4; ++i) {
          const float4 x = vr[i];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) fma4(o[r], i, s[r][j], x);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const size_t row = head + q0 + r0 + r * C::STRIDE;
    const float inv = 1.f / l[r];
    float4* dst = reinterpret_cast<float4*>(out + row * DH + off);
#pragma unroll
    for (int i = 0; i < PART / 4; ++i)
      dst[i] = make_float4(o[r][4 * i] * inv, o[r][4 * i + 1] * inv, o[r][4 * i + 2] * inv,
                           o[r][4 * i + 3] * inv);
    if (lse != nullptr && off == 0) lse[row] = m[r] * c + log2f(l[r]);
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, float* out, float* lse, int bh,
           int t, float scale, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(bh) * (t / BQ);
  if (blocks > 0x7fffffffLL) return -1;
  attention_fwd_f32_kernel<DH><<<unsigned(blocks), Fwd<DH>::THREADS, 0, stream>>>(
      q, k, v, out, lse, t, scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, out: contiguous fp32 (bh, t, dh), 16-byte aligned; lse: fp32
// (bh, t) or null (the rows' log-sum-exp of S * scale in log2 units, written
// only when given).  Returns 0 on success, the cudaError_t of the launch, or
// -1 for a shape the kernel does not take.  The kernel launches on the host
// thread's current device.
int s3d_spatial_attention_f32(const void* q, const void* k, const void* v, void* out,
                              void* lse, int bh, int t, int dh, float scale, void* stream) {
  if (bh <= 0 || t <= 0 || t % BQ != 0 || t % BK != 0) return -1;
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
