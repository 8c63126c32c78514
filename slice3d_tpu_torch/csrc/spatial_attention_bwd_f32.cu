// Softmax attention over the LDM UNet's flattened feature maps: backward (fp32).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_attention.py::_attention_backward
// (pallas_call at :150, body _attn_bwd_kernel) for fp32 inputs, the training
// precision of the JAX package's root CLI.  For every (batch, head), from q,
// k, v, the forward's output o and the row log-sum-exp L it saved
// (csrc/spatial_attention_f32.cu), and the output's gradient do, all
// (B, H, T, DH) fp32:
//
//   P  = softmax(q k^T * scale)              recomputed, P = exp2(S c - L)
//   dP = do v^T
//   dS = P * (dP - D) * scale, D = rowsum(do * o)
//   dq = dS k,  dk = dS^T q,  dv = P^T do
//
// in true fp32 (FMAs on the CUDA cores; no TF32, no bf16).  D = rowsum(do o)
// equals the TPU kernel's rowsum(dP P) in exact arithmetic; in fp32 the two
// differ by rounding, and the plain version (spatial_attention_bwd_ref)
// follows the TPU kernel, so kernel and plain version differ by summation
// order and the exponential.
//
// What bounds it on the H100: the five products, 10 T^2 DH flops per head
// as fp32 FMAs at 66.9 TFLOP/s (132 SMs x 128 lanes x 2 x 1980 MHz): 3.85 ms
// for the ds 1 block (8, 8, 4096, 24), 0.48 ms for the ds 2 block
// (8, 8, 1024, 48).  This design does seven (S and dP twice: 14 T^2 DH,
// 5.39 ms at ds 1) and two exponentials per logit (0.51 ms of ex2 at ds 1),
// for gradients summed with no atomics, in an order that does not change
// between runs.  The bytes (q, k, v, o, do read, dq, dk, dv written once:
// 0.2 GB at ds 1, 0.06 ms) are a sixtieth of the FMA bound.  A 3xTF32
// design on the tensor cores, in one pass, is later work (ROADMAP.md).
//
// Design: three plain SIMT kernels.
//   * delta: D = rowsum(do * o), one thread a row;
//   * dk/dv: a block owns BKEYS keys of one (batch, head); each thread holds
//     one key row (PART head dims of it: DH 24 one thread a row, DH 48 a
//     pair of lanes that add their halves of each dot product with one
//     shuffle) of k and v and its dk and dv accumulators in registers.
//     Tiles of BQS query rows of q, do, L and D pass through shared memory,
//     each staged element read as a broadcast; QC queries at a time each
//     thread forms S and dP for its key, P and dS, then dv += P do and
//     dk += dS q;
//   * dq: a block owns BQT query rows; each thread holds one of them (PART
//     dims) of q and do, L, D and its dq accumulator.  Tiles of BKS keys of
//     k and v pass through shared memory; KC keys at a time each thread
//     forms S, dP, P and dS and adds dS k.
// Both recompute S in the forward's order (the same products, summed over
// the head dims in the same order), so P = exp2(S c - L) is the forward's.
// The wrapper allocates delta; the kernels allocate nothing.
//
// Only fp32 with T a multiple of BKEYS, BQS, BQT and BKS and DH 24 or 48 (the
// UNet's), every tensor 16-byte aligned, is taken; the Python wrapper
// (slice3d_tpu_torch/ops/spatial_attention.py) raises on anything else.  Plain
// C interface, built with nvcc into a shared library and bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BKEYS = 128;  // keys per dk/dv block
constexpr int BQS = 64;     // query rows per staged tile of the dk/dv kernel
constexpr int QC = 8;       // queries per step of the dk/dv kernel
constexpr int BQT = 128;    // query rows per dq block
constexpr int BKS = 64;     // keys per staged tile of the dq kernel
constexpr int KC = 8;       // keys per step of the dq kernel
constexpr int PART = 24;    // head dims a thread holds of its row

template <int DH>
struct Bwd {
  static constexpr int SPLIT = DH / PART;  // threads a row: 1 or 2
  static constexpr int THREADS_KV = BKEYS * SPLIT;
  static constexpr int THREADS_Q = BQT * SPLIT;
  static_assert(DH % PART == 0 && (SPLIT == 1 || SPLIT == 2), "DH 24 or 48");
};

__device__ __forceinline__ void load_part(float (&dst)[PART], const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < PART / 4; ++i) {
    const float4 x = s4[i];
    dst[4 * i + 0] = x.x;
    dst[4 * i + 1] = x.y;
    dst[4 * i + 2] = x.z;
    dst[4 * i + 3] = x.w;
  }
}

__device__ __forceinline__ void store_part(float* dst, const float (&src)[PART]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < PART / 4; ++i)
    d4[i] = make_float4(src[4 * i], src[4 * i + 1], src[4 * i + 2], src[4 * i + 3]);
}

// sum over d of a[d] * x[d], d ascending (the forward's order for S)
__device__ __forceinline__ float dot_part(const float (&a)[PART], const float* x) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PART / 4; ++i) {
    const float4 y = x4[i];
    s = fmaf(a[4 * i + 0], y.x, s);
    s = fmaf(a[4 * i + 1], y.y, s);
    s = fmaf(a[4 * i + 2], y.z, s);
    s = fmaf(a[4 * i + 3], y.w, s);
  }
  return s;
}

// acc[d] += w * x[d]
__device__ __forceinline__ void axpy_part(float (&acc)[PART], float w, const float* x) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll
  for (int i = 0; i < PART / 4; ++i) {
    const float4 y = x4[i];
    acc[4 * i + 0] = fmaf(w, y.x, acc[4 * i + 0]);
    acc[4 * i + 1] = fmaf(w, y.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, y.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, y.w, acc[4 * i + 3]);
  }
}

// the whole dot product of a row split over a pair of lanes
template <int SPLIT>
__device__ __forceinline__ float pair_sum(float s) {
  if (SPLIT == 2) s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

// n rows of a (rows, DH) tensor from src into shared memory
template <int DH, int THREADS>
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n * DH / 4; i += THREADS) d4[i] = s4[i];
}

template <int DH>
__global__ void attention_bwd_delta_f32_kernel(const float* __restrict__ o,
                                               const float* __restrict__ dout,
                                               float* __restrict__ delta, int n_rows) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const float4* a = reinterpret_cast<const float4*>(o + size_t(row) * DH);
  const float4* b = reinterpret_cast<const float4*>(dout + size_t(row) * DH);
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < DH / 4; ++i) {
    const float4 x = a[i], y = b[i];
    d = fmaf(x.x, y.x, d);
    d = fmaf(x.y, y.y, d);
    d = fmaf(x.z, y.z, d);
    d = fmaf(x.w, y.w, d);
  }
  delta[row] = d;
}

// Block b owns the keys (b % (t / BKEYS)) * BKEYS .. + BKEYS - 1 of the
// (batch, head) b / (t / BKEYS).
template <int DH>
__global__ void __launch_bounds__(Bwd<DH>::THREADS_KV) attention_bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int t,
    float c, float scale) {
  using C = Bwd<DH>;
  __shared__ __align__(16) float qs[BQS * DH];
  __shared__ __align__(16) float dos[BQS * DH];
  __shared__ float ls[BQS], dls[BQS];

  const int tid = threadIdx.x;
  const int off = (tid % C::SPLIT) * PART;  // this thread's dims of the row
  const int n_kblocks = t / BKEYS;
  const size_t head = size_t(blockIdx.x / n_kblocks) * t;
  const size_t key = head + (blockIdx.x % n_kblocks) * BKEYS + tid / C::SPLIT;

  float kr[PART], vr[PART], dkr[PART], dvr[PART];
  load_part(kr, k + key * DH + off);
  load_part(vr, v + key * DH + off);
#pragma unroll
  for (int d = 0; d < PART; ++d) dkr[d] = dvr[d] = 0.f;

#pragma unroll 1
  for (int i0 = 0; i0 < t; i0 += BQS) {
    __syncthreads();  // every thread is done with the previous tile
    stage<DH, C::THREADS_KV>(qs, q + (head + i0) * DH, BQS);
    stage<DH, C::THREADS_KV>(dos, dout + (head + i0) * DH, BQS);
    for (int i = tid; i < BQS; i += C::THREADS_KV) {
      ls[i] = lse[head + i0 + i];
      dls[i] = delta[head + i0 + i];
    }
    __syncthreads();
#pragma unroll 1
    for (int ic = 0; ic < BQS; ic += QC) {
      float p[QC], ds[QC];
#pragma unroll
      for (int i = 0; i < QC; ++i) {
        const float s = pair_sum<C::SPLIT>(dot_part(kr, qs + (ic + i) * DH + off));
        const float dp = pair_sum<C::SPLIT>(dot_part(vr, dos + (ic + i) * DH + off));
        p[i] = exp2f(fmaf(s, c, -ls[ic + i]));
        ds[i] = p[i] * (dp - dls[ic + i]) * scale;
      }
#pragma unroll
      for (int i = 0; i < QC; ++i) {
        axpy_part(dvr, p[i], dos + (ic + i) * DH + off);
        axpy_part(dkr, ds[i], qs + (ic + i) * DH + off);
      }
    }
  }
  store_part(dk + key * DH + off, dkr);
  store_part(dv + key * DH + off, dvr);
}

// Block b owns the query rows (b % (t / BQT)) * BQT .. + BQT - 1 of the
// (batch, head) b / (t / BQT).
template <int DH>
__global__ void __launch_bounds__(Bwd<DH>::THREADS_Q) attention_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int t, float c, float scale) {
  using C = Bwd<DH>;
  __shared__ __align__(16) float ks[BKS * DH];
  __shared__ __align__(16) float vs[BKS * DH];

  const int tid = threadIdx.x;
  const int off = (tid % C::SPLIT) * PART;
  const int n_qblocks = t / BQT;
  const size_t head = size_t(blockIdx.x / n_qblocks) * t;
  const size_t row = head + (blockIdx.x % n_qblocks) * BQT + tid / C::SPLIT;

  float qr[PART], dor[PART], acc[PART];
  load_part(qr, q + row * DH + off);
  load_part(dor, dout + row * DH + off);
#pragma unroll
  for (int d = 0; d < PART; ++d) acc[d] = 0.f;
  const float lrow = lse[row], drow = delta[row];

#pragma unroll 1
  for (int j0 = 0; j0 < t; j0 += BKS) {
    __syncthreads();
    stage<DH, C::THREADS_Q>(ks, k + (head + j0) * DH, BKS);
    stage<DH, C::THREADS_Q>(vs, v + (head + j0) * DH, BKS);
    __syncthreads();
#pragma unroll 1
    for (int jc = 0; jc < BKS; jc += KC) {
      float ds[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float s = pair_sum<C::SPLIT>(dot_part(qr, ks + (jc + j) * DH + off));
        const float dp = pair_sum<C::SPLIT>(dot_part(dor, vs + (jc + j) * DH + off));
        const float p = exp2f(fmaf(s, c, -lrow));
        ds[j] = p * (dp - drow) * scale;
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) axpy_part(acc, ds[j], ks + (jc + j) * DH + off);
    }
  }
  store_part(dq + row * DH + off, acc);
}

template <int DH>
int launch(const float* q, const float* k, const float* v, const float* o, const float* dout,
           const float* lse, float* delta, float* dq, float* dk, float* dv, int bh, int t,
           float scale, cudaStream_t stream) {
  using C = Bwd<DH>;
  const long long n_rows = static_cast<long long>(bh) * t;
  if (n_rows > 0x7fffffffLL) return -1;
  const float c = scale * 1.4426950408889634f;
  attention_bwd_delta_f32_kernel<DH><<<unsigned((n_rows + 255) / 256), 256, 0, stream>>>(
      o, dout, delta, int(n_rows));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  attention_bwd_dkdv_f32_kernel<DH><<<unsigned(n_rows / BKEYS), C::THREADS_KV, 0, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, t, c, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  attention_bwd_dq_f32_kernel<DH><<<unsigned(n_rows / BQT), C::THREADS_Q, 0, stream>>>(
      q, k, v, dout, lse, delta, dq, t, c, scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o (the forward's output), dout, dq, dk, dv: contiguous fp32
// (bh, t, dh), 16-byte aligned; lse: the forward's fp32 (bh, t) row
// log-sum-exp (log2 units); delta: fp32 (bh, t) scratch.  Returns 0 on
// success, the cudaError_t of a launch, or -1 for a shape the kernels do not
// take.  The kernels launch on the host thread's current device.
int s3d_spatial_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, int bh, int t, int dh, float scale,
                                  void* stream) {
  if (bh <= 0 || t <= 0 || t % BKEYS != 0 || t % BQS != 0 || t % BQT != 0 || t % BKS != 0)
    return -1;
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
