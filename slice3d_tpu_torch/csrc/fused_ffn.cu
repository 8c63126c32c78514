// Fused ReLU FFN of the SDF head's split-encoder route (inference, bf16, sm_90a).
//
// Replaces the TPU kernel slice3d_tpu/ops/pallas_ffn.py::_fused_ffn_tpu
// (pallas_call at :49, body _kernel, reached through fused_ffn).  For every
// row of x (N, 128):
//
//   h   = relu(x W1^T + b1)      -> bf16   (fp32 accumulation, b1 in fp32)
//   out = h W2^T + b2            -> bf16   (fp32 accumulation, b2 in fp32)
//
// with W1 (F, 128) and W2 (128, F) in nn.Linear's layout, rounded to bf16 at
// the same two points as _kernel.
//
// What bounds it on the H100: 4 * 128 * F operations a row (1.05 MFLOP at F
// = 2048) against 512 bytes of activations in and out, ~2,000 operations a
// byte against the card's ~295: the tensor cores, and only through wgmma.
// The weights (1 MB in bf16 at F = 2048) do not fit in shared memory, so every
// row tile streams all of them from L2 (2.4 GB a call at N = 439,400 with the
// 192-row tiles below, counted from the tiling).
//
// Design: the F-tile loop of csrc/ffn_tile.cuh (shared with the encoder
// layer), in persistent warp-specialised blocks of CONSUMERS = 3 consumer
// warpgroups over row tiles of 192 rows; the producer loads each tile's x by
// TMA (two buffers, so the next tile's rows arrive under this one's products;
// rows past N arrive as zeros and are never stored) and streams the W1/W2
// F-tiles through the ring.  Three warpgroups read a third fewer weight bytes
// a row than two and hide each one's bias/ReLU epilogue under the others'
// products; they run at 128 registers a thread (setmaxnreg 152 for the
// consumers), which the loop fits without spilling.  Two warpgroups over
// 128-row tiles, with and without clusters of two that multicast every
// stage, read slower on the H100 (PERF.md).  Persistent: block b takes row
// tiles b, b + gridDim.x, ...  Dynamic shared memory 197,712 B a block: the
// ring (96 KB) and two x buffers (48 KB each).
//
// Only bf16 activations are taken, F a positive multiple of 64, every tensor
// 16-byte aligned; the Python wrapper (slice3d_tpu_torch/ops/fused_ffn.py)
// raises on anything else.  Plain C interface, built with nvcc into a shared
// library and bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ffn_tile.cuh"

namespace {

using namespace s3d;

constexpr int CONSUMERS = 3;   // consumer warpgroups of 64 rows

// Shared memory (bytes, from a 1024-byte boundary): the ring, then two
// swizzled x buffers of TILE_ROWS rows.
constexpr int TILE_ROWS = 64 * CONSUMERS;
constexpr int X_BYTES = TILE_ROWS * D * 2;         // one swizzled x buffer
constexpr int OFF_X = STAGES * STAGE_BYTES;        // after the ring
constexpr int OFF_BAR = OFF_X + 2 * X_BYTES;
constexpr int SMEM = OFF_BAR + (2 * STAGES + 4) * 8 + 1024;  // + alignment slack
// 128 registers a thread at launch, setmaxnreg 56 / 152
using WS3 = WarpSpecialised<CONSUMERS, 56, 152>;

__global__ void __launch_bounds__(WS3::THREADS, 1)
    ffn_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw1,
               const __grid_constant__ CUtensorMap tw2, const float* __restrict__ b1,
               const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int n, int f) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Ring<CONSUMERS * 4> ring;
  ring.stages = smem;
  ring.full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  ring.empty = ring.full + STAGES;
  uint64_t* xfull = ring.empty + STAGES;  // [2]
  uint64_t* xempty = xfull + 2;           // [2]
  uint8_t* xs = smem + OFF_X;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (n + TILE_ROWS - 1) / TILE_ROWS;

  if (tid == 0) {
    ring.init();
    for (int b = 0; b < 2; ++b) {
      mbar_init(&xfull[b], 1);
      mbar_init(&xempty[b], CONSUMERS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {  // the producer warpgroup: one thread issues every load
    regs_dec<WS3::PRODUCER>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x, i = 0; tile < n_tiles; tile += gridDim.x, ++i) {
        const int row0 = tile * TILE_ROWS, b = i & 1;
        if (i >= 2) mbar_wait(&xempty[b], ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(&xfull[b], X_BYTES);
        tma_load_2d(xs + b * X_BYTES, &tx, &xfull[b], 0, row0);
        tma_load_2d(xs + b * X_BYTES + X_BYTES / 2, &tx, &xfull[b], 64, row0);
        for (int j = 0; j < f / FT; ++j, ++it) ring.load_ffn(&tw1, &tw2, it, j);
      }
    }
    __syncwarp();
  } else {
    regs_inc<WS3::CONSUMER>();
    const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
    int it = 0;
    float acc[64];
#pragma unroll 1
    for (int tile = blockIdx.x, i = 0; tile < n_tiles; tile += gridDim.x, ++i) {
      const int row0 = tile * TILE_ROWS, b = i & 1;
      mbar_wait(&xfull[b], (i >> 1) & 1);
      ffn_accumulate(acc, xs + b * X_BYTES, TILE_ROWS, 64 * wg, ring, it, b1, f, lane);
      if (lane == 0) mbar_arrive(&xempty[b]);  // this warp's products have read x
      // out + b2 (fp32), rounded to bf16; rows g and g + 8 of this warp's 16
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 64 * wg + 16 * wl + g + 8 * hh;
        if (row >= n) continue;
        __nv_bfloat16* dst = out + size_t(row) * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + 8 * j + 2 * t4));
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(acc[4 * j + 2 * hh] + bb.x, acc[4 * j + 2 * hh + 1] + bb.y);
        }
      }
    }
  }
}

// The weight maps of one weight set (encoded once, by s3d_fused_ffn_maps).
struct Maps {
  CUtensorMap w1, w2;
};

}  // namespace

extern "C" {

// Bytes of the weight maps that s3d_fused_ffn_maps writes.
int s3d_fused_ffn_maps_bytes() { return int(sizeof(Maps)); }

// Encode the TMA maps of one weight set (w1 (f, 128), w2 (128, f), bf16,
// contiguous) into `maps` (s3d_fused_ffn_maps_bytes() bytes of host memory).
// Returns 0, or -2 if a map cannot be encoded.
int s3d_fused_ffn_maps(const void* w1, const void* w2, int f, void* maps) {
  Maps m;
  // W1 F-tiles arrive as two boxes of FT rows, W2's as one box of 128 rows
  if (encode_sw128(&m.w1, w1, uint64_t(f), D, D * 2, FT) ||
      encode_sw128(&m.w2, w2, D, uint64_t(f), uint64_t(f) * 2, D))
    return -2;
  memcpy(maps, &m, sizeof(Maps));
  return 0;
}

// Blocks of the kernel that an SM holds at once.  Returns 0 or a cudaError_t.
int s3d_fused_ffn_blocks_per_sm(int* blocks) {
  return resident_blocks(ffn_kernel, WS3::THREADS, SMEM, blocks);
}

// x, out: contiguous bf16 (n, 128); b1 (f,), b2 (128,) fp32; maps from
// s3d_fused_ffn_maps for this weight set.  Returns 0 on success, the
// cudaError_t of the launch, -1 for a shape the kernel does not take, -2 if
// a map cannot be encoded, -3 if the kernel was built with too few
// registers for its setmaxnreg, -4 on a device ordinal past MAX_DEVICES.
// The kernel launches on the host thread's current device.
int s3d_fused_ffn(const void* x, const void* maps, const void* b1, const void* b2, void* out,
                  int n, int f, void* stream) {
  if (n <= 0) return 0;
  if (f <= 0 || f % FT) return -1;
  Maps m;
  memcpy(&m, maps, sizeof(Maps));
  static DevicePrep prep;
  int grid = 0;
  const int prepared = prepare_on_device(prep, ffn_kernel, SMEM, WS3::MIN_LAUNCH, &grid);
  if (prepared != 0) return prepared;
  CUtensorMap tx;
  if (encode_sw128(&tx, x, uint64_t(n), D, D * 2, TILE_ROWS)) return -2;
  const int n_tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  ffn_kernel<<<n_tiles < grid ? n_tiles : grid, WS3::THREADS, SMEM,
               static_cast<cudaStream_t>(stream)>>>(
      tx, m.w1, m.w2, static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), n, f);
  return int(cudaGetLastError());
}

}  // extern "C"
