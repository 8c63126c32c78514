// Fused ReLU FFN of the SDF head's split-encoder route (inference, bf16).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_ffn.py::_fused_ffn_tpu
// (body _kernel, reached through fused_ffn).  For every row of x (N, 128):
//
//   h   = relu(x W1^T + b1)      -> bf16   (fp32 accumulation, b1 in fp32)
//   out = h W2^T + b2            -> bf16   (fp32 accumulation, b2 in fp32)
//
// with W1 (F, 128) and W2 (128, F) in nn.Linear's layout, rounded to bf16 at
// the same two points as _kernel.
//
// What bounds it: 4 * 128 * F operations per row (1.05 MFLOP at F = 2048)
// against 512 bytes of activations in and out, ~2,000 operations per byte,
// far above the card's ~295: compute-bound on the tensor cores.  The TPU
// kernel keeps the (1024, F) intermediate in VMEM; a Hopper block has 227 KB
// of shared memory and the weights alone are 1 MB in bf16.
//
// Design (simple and right first; wgmma/TMA/persistent blocks are later work):
// a block of 8 warps owns 128 rows, one m16 tile per warp, whose A fragments
// it loads once from shared memory; W1/W2 stream through a double-buffered
// cp.async ring in 64-wide F-tiles and the (rows, F) activation never leaves
// the registers -- the F-tile loop of csrc/ffn_tile.cuh, the same code as the
// FFN half of csrc/fused_encoder.cu.  Rows past N are zero in shared memory
// (a masked tail, no padded copy) and are never stored.
//
// Only bf16 activations are taken: an fp32 input has no instantiation here and
// the Python wrapper raises for it.
//
// Plain C interface, built with nvcc into a shared library and bound with
// ctypes (slice3d_tpu_torch/ops/fused_ffn.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ffn_tile.cuh"

namespace {

using namespace s3d;  // D, FT, LDW, STAGE, the mma/ldmatrix/cp.async helpers

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 16;  // rows per block

// shared memory layout, in bf16 elements: the FFN ring, then the x tile
constexpr int SM_RING = 0;                  // (2, STAGE)
constexpr int SM_X = SM_RING + 2 * STAGE;   // (ROWS, LDW)
constexpr int SM_TOTAL = SM_X + ROWS * LDW;
constexpr size_t SMEM_BYTES = size_t(SM_TOTAL) * 2;
static_assert(SMEM_BYTES <= 232448, "shared memory over the per-block limit");

struct Params {
  const __nv_bfloat16* x;   // (N, 128)
  const __nv_bfloat16* w1;  // (F, 128)  linear1.weight
  const float* b1;          // (F,)
  const __nv_bfloat16* w2;  // (128, F)  linear2.weight
  const float* b2;          // (128,)
  __nv_bfloat16* out;       // (N, 128)
  int n, f;
};

__global__ void __launch_bounds__(THREADS, 1) ffn_kernel(Params p) {
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * ROWS;
  __nv_bfloat16* xs = sm + SM_X;

  // this block's x rows -> shared memory; rows past N stay zero
  for (int i = tid; i < ROWS * 16; i += THREADS) {
    const int r = i >> 4, c = (i & 15) * 8;
    if (row0 + r < p.n) {
      cp_async16(xs + r * LDW + c, p.x + size_t(row0 + r) * D + c);
    } else {
      *reinterpret_cast<uint4*>(xs + r * LDW + c) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t ha[D / 16][4];
  load_a128(ha, xs + warp * 16 * LDW, lane);

  float out[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) out[j][0] = out[j][1] = out[j][2] = out[j][3] = 0.f;
  ffn_accumulate<THREADS>(out, ha, sm + SM_RING, p.w1, p.b1, p.w2, p.f, tid, lane);

  // out + b2 (fp32), rounded to bf16; rows g and g + 8 of this warp's tile
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + warp * 16 + g + 8 * half;
    if (row >= p.n) continue;
    __nv_bfloat16* dst = p.out + size_t(row) * D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t4;
      *reinterpret_cast<uint32_t*>(dst + c) =
          pack_bf16(out[j][2 * half] + __ldg(p.b2 + c), out[j][2 * half + 1] + __ldg(p.b2 + c + 1));
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes (ptxas reports static use only).
int s3d_fused_ffn_smem_bytes() { return int(SMEM_BYTES); }

// Returns 0 on success or the cudaError_t of the launch.
int s3d_fused_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, void* out, int n, int f, void* stream) {
  if (n <= 0) return 0;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const __nv_bfloat16*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.n = n;
  p.f = f;
  cudaError_t err = cudaFuncSetAttribute(ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const int blocks = (n + ROWS - 1) / ROWS;
  ffn_kernel<<<blocks, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

}  // extern "C"
