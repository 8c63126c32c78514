// Hopper (sm_90a) building blocks shared by the spatial attention kernels
// (csrc/spatial_attention.cu, csrc/spatial_attention_bwd.cu).
//
//   * mbarriers: init, arrive, arrive.expect_tx, try_wait.parity.  A wait
//     that has not completed after 10 s of the card's global timer
//     (WAIT_LIMIT_NS_1024; a legitimate wait here lasts microseconds) traps,
//     so a lost arrival fails the launch instead of hanging the card.  A trap
//     is a sticky error: it poisons the process's CUDA context, every later
//     CUDA call in the process fails, and only a new process recovers;
//   * TMA: 3-D tile loads (cp.async.bulk.tensor.3d, the tensor map passed as a
//     __grid_constant__ CUtensorMap), 1-D bulk loads, and the fp32 bulk
//     reduce-add into global memory;
//   * wgmma: the warpgroup's fences, commit and wait, shared-memory matrix
//     descriptors, and m64nNk16 bf16 products with fp32 accumulators, A from
//     shared memory (SS) or from registers (RS);
//   * named barriers and setmaxnreg for warp-specialised blocks;
//   * the online-softmax step of the forward;
//   * on the host: the tensor maps, encoded through the driver entry point
//     that cudaGetDriverEntryPoint returns (no -lcuda at link time).
//
// Shared-memory tiles.  A tile of q, k, v, do rows (head width DH 24 or 48)
// arrives by one TMA box of W = 32 or 64 columns (the columns past DH arrive
// as zeros, which pad the contractions over the head to depth 32 or 48) with
// TMA's 2W-byte swizzle, and is read by wgmma in the matching swizzled layout
// (HeadRows): as a K-major operand (contraction over the head: a k16 step is
// 32 bytes along the rows) or as an MN-major one (contraction over the rows:
// a k16 step is 16 rows).  A tile that threads write (the backward's dS) is
// kept un-swizzled, as slabs of 8 columns: a (rows, w) tile is w / 8 slabs of
// rows x 16 contiguous bytes, whose 8 x 8 blocks are the 128-byte core
// matrices of wgmma's interleaved layout (as an MN-major operand: core
// matrices 128 B apart along the rows (LBO), one slab apart along the
// columns (SBO)).

#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace s3d_attn {

// ---------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// The card's global timer in units of 1024 ns (32 bits: wraps after ~73 min).
__device__ __forceinline__ uint32_t timer_1024ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<uint32_t>(t >> 10);
}

constexpr uint32_t WAIT_LIMIT_NS_1024 = 9765625;  // 10 s in 1024 ns units

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of the given parity; trap
// (see the head of this file) if it has not completed in 10 s.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint32_t start = timer_1024ns();
  while (!mbar_try_wait(addr, parity))
    if (timer_1024ns() - start > WAIT_LIMIT_NS_1024) __trap();
}

// TMA and bulk copies

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// dst[i] += src[i] for bytes / 4 fp32 values, global <- shared, as one bulk group.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const float* src,
                                                    uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;" ::"l"(
                   dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {  // sources of all but N groups read
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {  // all but N groups complete
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// Generic-proxy shared-memory writes made visible to the async proxy (TMA, wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// named barriers and register reallocation

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so the compiler
// moves no access to them across a fence, commit or wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets, layout (0: un-swizzled, SW64 / SW128: TMA's 64- / 128-byte
// swizzle; see the head of this file).
constexpr uint32_t SW128 = 1, SW64 = 2;

__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout = 0) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(layout) << 62);
}

// A head of width DH (24 or 48) as a swizzled shared-memory row: padded to
// W columns (TMA fills the padding with zeros), ROW bytes a row, the wgmma
// layout of TMA's ROW-byte swizzle.  Tiles of such rows start at 1024-byte
// boundaries, and 8 rows (SBO bytes) are one swizzle atom.
template <int DH>
struct HeadRows {
  static constexpr int W = DH <= 32 ? 32 : 64;
  static constexpr int ROW = 2 * W;
  static constexpr int SBO = 8 * ROW;
  static constexpr uint32_t LAYOUT = ROW == 64 ? SW64 : SW128;
  static constexpr int DEPTH = (DH + 15) / 16;  // k16 steps of a contraction over the head
};

#define S3D_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d (64 x N, fp32) (+)= A (64 x 16, shared) B (16 x N, shared); TA / TB = 1
// for an MN-major A / B.  scale_d = 0 overwrites d.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 24 || N == 48 || N == 64, "no such wgmma shape here");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : S3D_D4(0), S3D_D4(4), S3D_D4(8), S3D_D4(12), S3D_D4(16), S3D_D4(20), S3D_D4(24),
          S3D_D4(28)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p, 1, 1, %27, %28;\n}\n"
        : S3D_D4(0), S3D_D4(4), S3D_D4(8), S3D_D4(12), S3D_D4(16), S3D_D4(20)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "%12, %13, p, 1, 1, %15, %16;\n}\n"
        : S3D_D4(0), S3D_D4(4), S3D_D4(8)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

// d (64 x N, fp32) += A (64 x 16, bf16 fragments in registers, the layout of
// mma.sync's m16n8k16 A per warp) B (16 x N, shared); TB = 1 for MN-major B.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 24 || N == 48, "no such wgmma shape here");
  if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
        : S3D_D4(0), S3D_D4(4), S3D_D4(8), S3D_D4(12), S3D_D4(16), S3D_D4(20)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1, %18;\n}\n"
        : S3D_D4(0), S3D_D4(4), S3D_D4(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
}

#undef S3D_D4

// The m64nN accumulator's element 4 j + 2 h + e is row 16 w + g + 8 h, column
// 8 j + 2 t + e of the warpgroup's tile (warp w, lane 4 g + t).  Its k16 block
// kk repacked as bf16 A fragments (keys 16 kk .. 16 kk + 15 of a 64 x 64 tile):
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// One online-softmax step over 64 keys of raw logits s (an m64n64
// accumulator: this thread's rows g, g + 8).  m is the running row max of the
// raw logits (the scale c = scale * log2(e) is positive, so the max commutes
// with it), l this thread's share of the row sums.  Leaves exp2(s c - m c) in
// s -- one FFMA and one ex2 per logit -- and the factors that rescale the
// earlier partial sums in alpha.
__device__ __forceinline__ void online_softmax_step(float (&s)[32], float (&m)[2],
                                                    float (&l)[2], float (&alpha)[2],
                                                    float c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float neg_mc = -mx * c;
    alpha[h] = exp2_approx(fmaf(m[h], c, neg_mc));  // 0 on the first step (m = -inf)
    m[h] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float& a = s[4 * j + 2 * h];
      float& b = s[4 * j + 2 * h + 1];
      a = exp2_approx(fmaf(a, c, neg_mc));
      b = exp2_approx(fmaf(b, c, neg_mc));
      sum += a + b;
    }
    l[h] = fmaf(l[h], alpha[h], sum);
  }
}

// ------------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map of a row-major bf16 (heads, rows, width) tensor read in boxes of
// box_cols x box_rows (of one head) with TMA's box_cols * 2 byte swizzle (64
// or 128).  Columns past width and rows past rows arrive as zeros.  Returns
// 0, or -2 on failure.
inline int encode_rows(CUtensorMap* map, const void* ptr, uint64_t heads, uint64_t rows,
                       uint32_t width, uint32_t box_cols, uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || (box_cols != 32 && box_cols != 64)) return -2;
  const cuuint64_t dims[3] = {width, rows, heads};
  const cuuint64_t strides[2] = {uint64_t(width) * 2, uint64_t(width) * 2 * rows};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

// Warp-specialised kernels here run CONSUMERS warpgroups and one more that
// feeds them; that one gives registers to the consumers with setmaxnreg.  The
// consumers' increase is only granted if the kernel starts with at least
// MIN_LAUNCH registers a thread (ptxas gives a kernel of one block an SM all
// that the block's threads leave: 168 at 384 threads, 128 at 512), else they
// would wait for it forever.
template <int CONSUMERS_, int PRODUCER_, int CONSUMER_>
struct WarpSpecialised {
  static constexpr int CONSUMERS = CONSUMERS_;
  static constexpr int THREADS = (CONSUMERS + 1) * 128;
  static constexpr int PRODUCER = PRODUCER_;  // registers a thread after setmaxnreg
  static constexpr int CONSUMER = CONSUMER_;
  static constexpr int MIN_LAUNCH =
      (CONSUMERS * 128 * CONSUMER + 128 * PRODUCER + THREADS - 1) / THREADS;
};

// Once per kernel: allow its dynamic shared memory and check its registers.
// Returns 0, a cudaError_t, or -3 if the kernel was built with fewer than
// min_regs registers, too few for the consumers' setmaxnreg.
template <typename Kernel>
int prepare_ws_kernel(Kernel kernel, int smem_bytes, int min_regs) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return int(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return int(err);
  return attr.numRegs >= min_regs ? 0 : -3;
}

}  // namespace s3d_attn
