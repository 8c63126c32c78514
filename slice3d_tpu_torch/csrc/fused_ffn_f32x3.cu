// Fused ReLU FFN of the SDF head's split-encoder route (inference, fp32,
// 3xTF32 on Hopper's tensor cores, sm_90a).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_ffn.py::_fused_ffn_tpu
// (pallas_call at :49, body _kernel :35) for fp32 inputs, which the JAX
// package sends there at --dtype float32 (fused_ffn :70 runs the kernel at
// the input's dtype).  Over N rows of width 128:
//
//   out = relu(x W1^T + b1) W2^T + b2       W1 (F, 128), W2 (128, F)
//
// in fp32 in and out; every rounding point of the TPU kernel is the
// identity in fp32.  Each product runs as three TF32 products of split
// operands (csrc/ffn_tile_f32x3.cuh), so the kernel differs from the plain
// version (fused_ffn_ref) by rounding at the fp32 level and summation order.
//
// What bounds it on the H100: 4 * 128 * F flops a row (1 MFLOP at F = 2048)
// against 1 KB of x in and out, as three TF32 products each on the tensor
// cores (132 SMs x 2,048 TF32 flops a clock: 535 TFLOP/s at 1980 MHz, an
// fp32 rate of 178 TFLOP/s): 2.58 ms at N = 439,400 rows, 0.199 ms at N =
// 33,800.  The (N, F) activation (3.6 GB in fp32 at N = 439,400) never
// reaches device memory; the weights' hi and lo planes (4 MB) stream from L2
// once a 128-row tile (13.7 GB a call at N = 439,400, counted from the
// tiling).
//
// Design: csrc/ffn_tile_f32x3.cuh's F-tile loop in persistent blocks, one an
// SM, of two consumer warpgroups (64 rows each, setmaxnreg 232) and one
// producer warpgroup, one thread of which streams the packed weight items
// through a 3-slot ring by 1-D bulk copies on mbarriers.  Block b takes the
// 128-row tiles b, b + gridDim.x, ...; a warpgroup whose 64 rows lie past N
// only releases the items (the last tile of N = 33,800 holds 8 rows: its
// second warpgroup idles and the first runs alone).  Dynamic shared memory
// 229,424 B: the x planes (128 KB) and the ring (96 KB).  Registers (ptxas
// -v on the H100, sm_90a): 168 a thread at launch, no spills.
//
// Only fp32 x is taken, with D 128 and F a positive multiple of 32, every
// tensor 16-byte aligned; the Python wrapper
// (slice3d_tpu_torch/ops/fused_ffn.py) raises on anything else.  Plain C
// interface, built with nvcc into a shared library and bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ffn_tile_f32x3.cuh"

namespace {

using namespace s3d_x3;

constexpr int CONSUMERS = 2;  // consumer warpgroups of 64 rows
// and one producer warpgroup: 168 registers a thread at launch, setmaxnreg
// 40 / 232
using WS = WarpSpecialised<CONSUMERS, 40, 232>;
constexpr int THREADS = WS::THREADS;
constexpr int OFF_RING = 2 * X_PLANE_BYTES;
constexpr int OFF_BAR = OFF_RING + STAGES * ITEM_BYTES;
constexpr int SMEM = OFF_BAR + 2 * STAGES * 8;
static_assert(SMEM <= 232448, "shared memory over the per-block limit");
static_assert(CONSUMER_WARPS == 4 * CONSUMERS, "the ring counts every consumer warp");

__global__ void __launch_bounds__(THREADS, 1)
    ffn_x3_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                  const float* __restrict__ b1, const float* __restrict__ b2,
                  float* __restrict__ out, int n, int f) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* xh = smem;
  uint8_t* xl = smem + X_PLANE_BYTES;
  Ring ring;
  ring.slots = smem + OFF_RING;
  ring.full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  ring.empty = ring.full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_items = 2 * (f / FT);
  const int n_tiles = (n + ROWS - 1) / ROWS;

  if (tid == 0) {
    ring.init();
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // the producer: one thread streams every item
    regs_dec<WS::PRODUCER>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int i = 0; i < n_items; ++i, ++it)
          ring.load(it, w + size_t(i) * ITEM_BYTES);
    }
    return;
  }

  regs_inc<WS::CONSUMER>();
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  int it = 0;
  float acc[64];
#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS + 64 * wg;
    if (row0 >= n) {  // no rows for this warpgroup: keep the ring in step
#pragma unroll 1
      for (int i = 0; i < n_items; ++i, ++it) {
        ring.acquire(it);
        ring.release(it, lane);
      }
      continue;
    }
    named_sync(1 + wg, 128);  // the warpgroup's products of the last tile have read x
    split_x_rows(xh, xl, 64 * wg, x, row0, n, tid & 127);
    fence_proxy_async();
    named_sync(1 + wg, 128);
    ffn_rows(acc, xh, xl, 64 * wg, ring, it, b1, f, lane);
    // out + b2: rows g and g + 8 of this warp's 16
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 16 * wl + g + 8 * hh;
      if (row >= n) continue;
      float* dst = out + size_t(row) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + 8 * j + 2 * t4));
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * hh] + bb.x, acc[4 * j + 2 * hh + 1] + bb.y);
      }
    }
  }
}

}  // namespace

extern "C" {

// Blocks of the kernel that an SM holds at once.  Returns 0 or a cudaError_t.
int s3d_fused_ffn_f32_blocks_per_sm(int* blocks) {
  return resident_blocks(ffn_x3_kernel, THREADS, SMEM, blocks);
}

// x, out: contiguous fp32 (n, 128); w: the packed weight stream (f / 32 F-tiles
// of a W1 and a W2 item, each a hi and a lo TF32 plane,
// ops/fused_ffn.py::ffn_stream_f32x3); b1 (f,), b2 (128,) fp32; every
// pointer 16-byte aligned.  Returns 0 on success, the cudaError_t of the
// launch, -1 for a shape the kernel does not take, -3 if the kernel was
// built with too few registers for its setmaxnreg, -4 on a device ordinal
// past MAX_DEVICES.  The kernel launches on the host thread's current device.
int s3d_fused_ffn_f32(const void* x, const void* w, const void* b1, const void* b2, void* out,
                      int n, int f, void* stream) {
  if (n <= 0) return 0;
  if (f <= 0 || f % FT) return -1;
  static DevicePrep prep;
  int sms = 0;
  const int prepared = prepare_on_device(prep, ffn_x3_kernel, SMEM, WS::MIN_LAUNCH, &sms);
  if (prepared != 0) return prepared;
  const int n_tiles = (n + ROWS - 1) / ROWS;
  ffn_x3_kernel<<<n_tiles < sms ? n_tiles : sms, THREADS, SMEM,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(b1), static_cast<const float*>(b2), static_cast<float*>(out),
      n, f);
  return int(cudaGetLastError());
}

}  // extern "C"
