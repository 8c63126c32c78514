// Hopper (sm_90a) building blocks shared by the port's hand-written kernels:
// the spatial attention kernels (csrc/spatial_attention.cu,
// csrc/spatial_attention_bwd.cu, and in fp32 csrc/spatial_attention_f32x3.cu,
// csrc/spatial_attention_bwd_f32x3.cu) and, through csrc/ffn_tile.cuh and
// csrc/ffn_tile_f32x3.cuh, the SDF head's (csrc/fused_encoder.cu,
// csrc/fused_ffn.cu, csrc/fused_encoder_f32x3.cu, csrc/fused_ffn_f32x3.cu).
//
//   * mbarriers: init, arrive, arrive.expect_tx, try_wait.parity.  A wait
//     that has not completed after 10 s of the card's global timer
//     (WAIT_LIMIT_NS_1024; a legitimate wait here lasts microseconds) traps,
//     so a lost arrival fails the launch instead of hanging the card.  A trap
//     is a sticky error: it poisons the process's CUDA context, every later
//     CUDA call in the process fails, and only a new process recovers;
//   * TMA: 2-D and 3-D tile loads (cp.async.bulk.tensor, the tensor map
//     passed as a __grid_constant__ CUtensorMap), 1-D bulk loads, and the
//     fp32 bulk reduce-add into global memory;
//   * wgmma: the warpgroup's fences, commit and wait, shared-memory matrix
//     descriptors, and m64nNk16 bf16 products with fp32 accumulators, A from
//     shared memory (SS) or from registers (RS);
//   * wgmma m64nNk8 TF32 products (SS and RS), the hi/lo split and the
//     K-major planes of 3xTF32 fp32 products, and the splitting warpgroup
//     of the fp32 attention kernels, which splits streamed tiles into planes
//     while two consumer warpgroups run the products;
//   * named barriers and setmaxnreg for warp-specialised blocks;
//   * the online-softmax step of the forward;
//   * on the host: the tensor maps, encoded through the driver entry point
//     that cudaGetDriverEntryPoint returns (no -lcuda at link time), and the
//     grid and occupancy of a persistent kernel.
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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
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
  static_assert(N == 24 || N == 48 || N == 64 || N == 128, "no such wgmma shape here");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : S3D_D4(0), S3D_D4(4), S3D_D4(8), S3D_D4(12), S3D_D4(16), S3D_D4(20), S3D_D4(24),
          S3D_D4(28), S3D_D4(32), S3D_D4(36), S3D_D4(40), S3D_D4(44), S3D_D4(48), S3D_D4(52),
          S3D_D4(56), S3D_D4(60)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
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
  static_assert(N == 24 || N == 48 || N == 128, "no such wgmma shape here");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : S3D_D4(0), S3D_D4(4), S3D_D4(8), S3D_D4(12), S3D_D4(16), S3D_D4(20), S3D_D4(24),
          S3D_D4(28), S3D_D4(32), S3D_D4(36), S3D_D4(40), S3D_D4(44), S3D_D4(48), S3D_D4(52),
          S3D_D4(56), S3D_D4(60)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  } else if constexpr (N == 48) {
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

// fp32 on the tensor cores: 3xTF32.  wgmma takes fp32 only as TF32 (8 bits
// of exponent, 10 of mantissa), read from a 32-bit word whose low 13 bits it
// ignores.  A value x is split into hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest (ties away from zero), so x = hi + lo to within
// 2^-22 |x|, and a product is taken as hi.hi + hi.lo + lo.hi in the fp32
// accumulator (lo.lo, ~2^-22 of it, is dropped): three k8 products on the
// tensor cores for one fp32 product.  tf32 operands have no transpose bit
// (only 16-bit types do), so both operands are K-major.
//
// Planes.  The kernels keep each split operand as two planes (hi, lo) in
// wgmma's un-swizzled K-major core-matrix layout: a tile of R rows (a
// multiple of 8) by K columns (a multiple of 8) is K / 4 slabs of R x 16
// contiguous bytes, element (r, c) at byte (c / 4) R 16 + 16 r + 4 (c % 4);
// each 8 x 4 block is a 128-byte core matrix (core matrices R 16 bytes apart
// along K: LBO; 128 bytes apart along the rows: SBO).  Threads write the
// planes (they split the values), 16 contiguous bytes a row, so a quarter
// warp stores 128 contiguous bytes.
//
// Register A operands.  The A fragment of an m64nNk8 tf32 product holds, in
// warp w and lane 4 g + t, rows 16 w + g (+ 8) and columns t and t + 4 of the
// k8 step; an accumulator holds columns 2 t and 2 t + 1.  So an accumulator's
// k8 block j becomes the A fragment of a k8 step whose contraction index is
// permuted within the block: fragment column k is the accumulator's column
// kperm(k) = 2 (k % 4) + k / 4, and the paired B operand stores contraction
// index 8 j + kperm(k) in its column 8 j + k.

__device__ __forceinline__ int kperm(int k) { return 2 * (k & 3) + (k >> 2); }

// x = hi + lo, both TF32 (low 13 bits zero), each rounded to nearest
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// Four values split and stored as 16 bytes of a hi plane and of a lo plane.
__device__ __forceinline__ void tf32_split_store4(uint8_t* hi, uint8_t* lo, float4 x) {
  uint4 h, l;
  tf32_split(x.x, h.x, l.x);
  tf32_split(x.y, h.y, l.y);
  tf32_split(x.z, h.z, l.z);
  tf32_split(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

// Byte offset of element (r, c) of a plane of R rows (see above).
template <int R>
__device__ __forceinline__ uint32_t plane_offset(int r, int c) {
  return uint32_t((c >> 2) * (R * 16) + r * 16 + (c & 3) * 4);
}

// Descriptor of k8 step kk of a plane of R rows, from row r0 (a multiple of 8).
template <int R>
__device__ __forceinline__ uint64_t plane_desc(const uint8_t* plane, int r0, int kk) {
  return smem_desc(plane + kk * 2 * R * 16 + r0 * 16, R * 16, 128);
}

#define S3D_X4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d (64 x N, fp32) (+)= A (64 x 8, shared, K-major) B (8 x N, shared,
// K-major), one TF32 product; scale_d = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[N / 2], uint64_t da, uint64_t db,
                                              int scale_d) {
  static_assert(N == 32 || N == 64 || N == 96 || N == 128, "no such wgmma shape here");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n}\n"
        : S3D_X4(0), S3D_X4(4), S3D_X4(8), S3D_X4(12), S3D_X4(16), S3D_X4(20), S3D_X4(24),
          S3D_X4(28), S3D_X4(32), S3D_X4(36), S3D_X4(40), S3D_X4(44), S3D_X4(48), S3D_X4(52),
          S3D_X4(56), S3D_X4(60)
        : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (N == 96) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1;\n}\n"
        : S3D_X4(0), S3D_X4(4), S3D_X4(8), S3D_X4(12), S3D_X4(16), S3D_X4(20), S3D_X4(24),
          S3D_X4(28), S3D_X4(32), S3D_X4(36), S3D_X4(40), S3D_X4(44)
        : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : S3D_X4(0), S3D_X4(4), S3D_X4(8), S3D_X4(12)
        : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : S3D_X4(0), S3D_X4(4), S3D_X4(8), S3D_X4(12), S3D_X4(16), S3D_X4(20), S3D_X4(24),
          S3D_X4(28)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d (64 x N, fp32) (+)= A (64 x 8, TF32 fragments in registers) B (8 x N,
// shared, K-major), one TF32 product; scale_d = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  static_assert(N == 24 || N == 48 || N == 128, "no such wgmma shape here");
  if constexpr (N == 24) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
        : S3D_X4(0), S3D_X4(4), S3D_X4(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : S3D_X4(0), S3D_X4(4), S3D_X4(8), S3D_X4(12), S3D_X4(16), S3D_X4(20)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : S3D_X4(0), S3D_X4(4), S3D_X4(8), S3D_X4(12), S3D_X4(16), S3D_X4(20), S3D_X4(24),
          S3D_X4(28), S3D_X4(32), S3D_X4(36), S3D_X4(40), S3D_X4(44), S3D_X4(48), S3D_X4(52),
          S3D_X4(56), S3D_X4(60)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}

#undef S3D_X4

// One fp32 k8 step as three TF32 products, smallest first: d (+)= A_lo B_hi
// + A_hi B_lo + A_hi B_hi, A and B from their hi and lo planes.
template <int N>
__device__ __forceinline__ void tf32x3_ss(float (&d)[N / 2], uint64_t a_hi, uint64_t a_lo,
                                          uint64_t b_hi, uint64_t b_lo, int scale_d) {
  wgmma_ss_tf32<N>(d, a_lo, b_hi, scale_d);
  wgmma_ss_tf32<N>(d, a_hi, b_lo, 1);
  wgmma_ss_tf32<N>(d, a_hi, b_hi, 1);
}

// The same with A's hi and lo fragments in registers.
template <int N>
__device__ __forceinline__ void tf32x3_rs(float (&d)[N / 2], const uint32_t (&a_hi)[4],
                                          const uint32_t (&a_lo)[4], uint64_t b_hi,
                                          uint64_t b_lo, int scale_d) {
  wgmma_rs_tf32<N>(d, a_lo, b_hi, scale_d);
  wgmma_rs_tf32<N>(d, a_hi, b_lo, 1);
  wgmma_rs_tf32<N>(d, a_hi, b_hi, 1);
}

// The k8 blocks j0 .. j0 + J - 1 of an m64nN accumulator (N = 2 M) as split
// A fragments, the contraction index permuted within each block (kperm
// above).  j0 is a constant where the caller's loops unroll.
template <int J, int M>
__device__ __forceinline__ void tf32x3_from_acc(uint32_t (&hi)[J][4], uint32_t (&lo)[J][4],
                                                const float (&d)[M], int j0 = 0) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float* b = d + 4 * (j0 + j);
    tf32_split(b[0], hi[j][0], lo[j][0]);  // row g, column kperm(t) = 2 t
    tf32_split(b[2], hi[j][1], lo[j][1]);  // row g + 8, column 2 t
    tf32_split(b[1], hi[j][2], lo[j][2]);  // row g, column kperm(t + 4) = 2 t + 1
    tf32_split(b[3], hi[j][3], lo[j][3]);  // row g + 8, column 2 t + 1
  }
}

// Rows [0, ROWS) of DH fp32 at src (global or shared, 16-byte aligned) ->
// rows r0 .. of hi, lo planes of PR rows whose contraction runs over the
// head; t: the thread's index among NT.  A quarter warp takes 8 rows, row
// r8 its 16-byte piece (c + r8 / ROT) % NCH: the stores fill the 8 rows of
// a core-matrix column, in distinct banks, and the loads from rows DH * 4
// bytes apart fall in distinct banks too.
template <int ROWS, int PR, int DH, int NT>
__device__ __forceinline__ void split_rows(const float* src, uint8_t* hi, uint8_t* lo, int r0,
                                           int t) {
  constexpr int NCH = DH / 4;
  constexpr int ROT = DH == 48 ? 2 : 4;
  static_assert(ROWS * NCH % NT == 0, "whole float4s a thread");
#pragma unroll
  for (int k = 0; k < ROWS * NCH / NT; ++k) {
    const int i = t + NT * k;
    const int rest = i >> 3, r8 = i & 7;
    const int c = (rest % NCH + r8 / ROT) % NCH, r = (rest / NCH) * 8 + r8;
    const uint32_t off = plane_offset<PR>(r0 + r, 4 * c);
    tf32_split_store4(hi + off, lo + off, reinterpret_cast<const float4*>(src)[r * NCH + c]);
  }
}

// Rows [0, ROWS) of DH fp32 at src (shared) -> hi, lo planes of DH rows whose
// contraction runs over the ROWS rows, row m in column 8 (m / 8) + kslot(m %
// 8): column 4 cc + e holds row 8 (cc / 2) + kperm(4 (cc % 2) + e) = 8 (cc /
// 2) + 2 e + cc % 2.  A thread stores 16 bytes of a plane row; a quarter
// warp, 8 rows of one core matrix.
template <int ROWS, int DH, int NT>
__device__ __forceinline__ void split_cols(const float* src, uint8_t* hi, uint8_t* lo, int t) {
  constexpr int ITEMS = DH * ROWS / 4;
  static_assert(ITEMS % NT == 0, "whole items a thread");
#pragma unroll
  for (int k = 0; k < ITEMS / NT; ++k) {
    const int i = t + NT * k;
    const int d = 8 * ((i >> 3) % (DH / 8)) + (i & 7), cc = (i >> 3) / (DH / 8);
    const float* col = src + (8 * (cc >> 1) + (cc & 1)) * DH + d;
    const uint32_t off = plane_offset<DH>(d, 4 * cc);
    tf32_split_store4(hi + off, lo + off,
                      make_float4(col[0], col[2 * DH], col[4 * DH], col[6 * DH]));
  }
}

// The fp32 attention kernels' mbarriers: raw_full[2] (the bulk copies'
// bytes), full[2] (every splitting thread), empty[2] (every consumer warp),
// initialised by thread 0 before the block's first barrier.
__device__ __forceinline__ void split_bars_init(uint64_t* bars, int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&bars[b], 1);
      mbar_init(&bars[2 + b], 128);
      mbar_init(&bars[4 + b], consumer_warps);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The splitting warpgroup's loop (its thread t of 128, its named barrier
// bar): per tile j, wait for stage j % 2 to be free and for raw tile j to
// land, split it into the stage (split(raw, stage, t)), release the stage
// to the consumers, and, once all its threads have read the raw tile, copy
// tile j + 2 into it (fetch(j + 2)).  The consumers wait on full[j % 2] and
// each of their warps arrives on empty[j % 2] once its products have read
// the stage.
template <class Split, class Fetch>
__device__ __forceinline__ void splitter_loop(int t, int bar, int n_tiles, int raw_bytes,
                                              int stage_bytes, uint8_t* raws, uint8_t* stages,
                                              uint64_t* raw_full, uint64_t* full,
                                              uint64_t* empty, Split split, Fetch fetch) {
  if (t == 0) {
    fetch(0);
    if (n_tiles > 1) fetch(1);
  }
#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    const int b = j & 1;
    if (j >= 2) mbar_wait(&empty[b], ((j >> 1) & 1) ^ 1);
    mbar_wait(&raw_full[b], (j >> 1) & 1);
    split(reinterpret_cast<const float*>(raws + b * raw_bytes), stages + b * stage_bytes, t);
    fence_proxy_async();
    mbar_arrive(&full[b]);
    if (j + 2 < n_tiles) {
      named_sync(bar, 128);
      if (t == 0) fetch(j + 2);
    }
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

// A map of a row-major bf16 (rows, cols) matrix whose rows lie row_bytes
// apart, read in boxes of 64 columns x box_rows rows with TMA's 128-byte
// swizzle (the layout a K-major wgmma operand of 64-column halves reads).
// Rows past `rows` arrive as zeros.  Returns 0, or -2 on failure.
inline int encode_sw128(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
                        uint64_t row_bytes, uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

// Blocks of a persistent kernel: one an SM.  Returns 0 or a cudaError_t.
inline int persistent_grid(int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(grid, cudaDevAttrMultiProcessorCount, dev);
  return int(err);
}

// Blocks of `kernel` that an SM holds at once (its shared memory allowed
// first).  Returns 0 or a cudaError_t.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, int smem_bytes, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem_bytes);
  return int(err);
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

// Devices a process may launch on; a launch on a higher ordinal returns -4.
constexpr int MAX_DEVICES = 64;

// A launcher's preparation, kept per device: the shared-memory attribute and
// the register check belong to the (kernel, device) pair, the SM count to the
// device.  status[d] is 1 until device d is prepared, then what preparing
// returned; sms[d] is its SM count, the grid of a persistent kernel.
struct DevicePrep {
  int status[MAX_DEVICES];
  int sms[MAX_DEVICES];
  DevicePrep() {
    for (int d = 0; d < MAX_DEVICES; ++d) {
      status[d] = 1;
      sms[d] = 0;
    }
  }
};

// Prepare `kernel` on the host thread's current device, the one `<<<>>>`
// launches on, the first time it launches there.  Returns 0 with the
// device's SM count in *sms, or what preparing returned (-4: an ordinal of
// MAX_DEVICES or more).
template <typename Kernel>
int prepare_on_device(DevicePrep& prep, Kernel kernel, int smem_bytes, int min_regs, int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev < 0 || dev >= MAX_DEVICES) return -4;
  if (prep.status[dev] == 1) {
    int s = prepare_ws_kernel(kernel, smem_bytes, min_regs);
    if (s == 0) s = persistent_grid(&prep.sms[dev]);
    prep.status[dev] = s;
  }
  *sms = prep.sms[dev];
  return prep.status[dev];
}

}  // namespace s3d_attn
