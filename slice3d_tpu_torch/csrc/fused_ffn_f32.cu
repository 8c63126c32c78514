// Fused ReLU FFN of the SDF head's split-encoder route (inference, fp32, sm_90a).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_ffn.py::_fused_ffn_tpu
// (pallas_call at :49, body _kernel :35) for fp32 inputs, which the JAX
// package sends there at --dtype float32 (fused_ffn :70 runs the kernel at
// the input's dtype).  Over N rows of width 128:
//
//   out = relu(x W1^T + b1) W2^T + b2       W1 (F, 128), W2 (128, F)
//
// in true fp32 (no TF32, no bf16): every rounding point of the TPU kernel is
// the identity in fp32, so the kernel differs from the plain version
// (fused_ffn_ref) by summation order alone.
//
// What bounds it on the H100: 4 * 128 * F flops a row as fp32 FMAs (1 MFLOP
// at F = 2048) against 1 KB of x in and out: the FMA rate, 66.9 TFLOP/s at
// 132 SMs x 128 lanes x 2 x 1980 MHz: 6.89 ms at N = 439,400 rows, 0.53 ms
// at N = 33,800.  The (N, F) activation (3.6 GB in fp32 at N = 439,400)
// never reaches device memory.
//
// Design: csrc/ffn_tile_f32.cuh's F-tile loop on one 128-row tile a block
// (256 threads, 8 x 8 outputs a thread in registers, 200,704 B of shared
// memory: the tile, the F-tile activation and a 3-stage weight ring), one
// block an SM.  The tile's rows arrive by cp.async with the first weight
// stage; every tile streams all of W1 and W2 (1 MB at F = 2048) from L2,
// packed F-tile by F-tile (ops/prepared.py): 3.6 GB a call at N = 439,400
// (3,433 tiles), counted from the tiling.  The blocks are not persistent:
// a block's weight ring restarts with its tile, which costs one stage's L2
// latency against ~0.27 ms of products.
//
// Only fp32 x is taken, with D 128 and F a positive multiple of 64, every
// tensor 16-byte aligned; the Python wrapper
// (slice3d_tpu_torch/ops/fused_ffn.py) raises on anything else.  Plain C
// interface, built with nvcc into a shared library and bound with ctypes.

#include "ffn_tile_f32.cuh"

namespace {

using namespace s3d_f32;

constexpr int SMEM = (ROWS * LDX + ROWS * LDH + STAGES * FFN_STAGE) * 4;
static_assert(SMEM <= 232448, "shared memory over the per-block limit");

// Block b: rows b * ROWS .. of x (n, D) -> out (n, D); w: the packed
// stream of 2 f / FT stages (W1 F-tile [D][FT], then W2 F-tile [FT][D]).
__global__ void __launch_bounds__(THREADS, 1)
    ffn_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b1, const float* __restrict__ b2,
                   float* __restrict__ out, int n, int f) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;
  float* H = X + ROWS * LDX;
  float* W = H + ROWS * LDH;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, n - row0);

  load_rows(X, x + size_t(row0) * D, D, rows);
  FfnRing ring;
  ring.init(W, w, 2 * (f / FT));

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  ffn_tile(acc, X, H, ring, b1, f, ty, tx);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float bias = b2[tile_col<8>(tx, j)];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] += bias;
  }
  store_rows(out + size_t(row0) * D, acc, rows, ty, tx);
}

}  // namespace

extern "C" {

// Blocks of the kernel that an SM holds at once.  Returns 0 or a cudaError_t.
int s3d_fused_ffn_f32_blocks_per_sm(int* blocks) {
  return resident_blocks(ffn_f32_kernel, SMEM, blocks);
}

// x, out: contiguous fp32 (n, 128); w: the packed fp32 weights (2 f / 64
// stages of 8,192 floats, ops/prepared.py); b1 (f,), b2 (128,) fp32; every
// pointer 16-byte aligned.  Returns 0 on success, the cudaError_t of the
// launch, or -1 for a shape the kernel does not take.  The kernel launches
// on the host thread's current device.
int s3d_fused_ffn_f32(const void* x, const void* w, const void* b1, const void* b2, void* out,
                      int n, int f, void* stream) {
  if (n <= 0) return 0;
  if (f <= 0 || f % FT) return -1;
  cudaError_t e =
      cudaFuncSetAttribute(ffn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return int(e);
  ffn_f32_kernel<<<(n + ROWS - 1) / ROWS, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b1), static_cast<const float*>(b2), static_cast<float*>(out), n,
      f);
  return int(cudaGetLastError());
}

}  // extern "C"
