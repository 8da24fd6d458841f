// tf32.cuh: split-TF32 ("3xTF32") products on Hopper's tensor cores for
// the f32 attention routes, flash_attention.cu (the forward) and the
// f32 route of flash_attention_bwd.cu (the backward).
//
// An f32 operand x is written as hi + lo, hi = tf32(x) and lo = tf32(x -
// hi), and a product a b is taken as hi_a lo_b + lo_a hi_b + hi_a hi_b,
// the small terms first, into f32 accumulators: each term errs by about
// 2^-21 of itself where one TF32 product alone keeps 11 bits.  bf16
// values are exact in TF32 (8 significant bits of 11), so a bf16 operand
// has lo = 0 and its two lo terms are left out.
//
// hi and lo are rounded here, by integer operations on the f32 word: to
// nearest, ties away from zero, the rule of cvt.rna.tf32.f32.  Their low 13
// bits are then zero, so the kernels do not rely on how the tensor cores
// treat the low mantissa bits of a raw f32 word; and the CPU tests emulate
// the rounding bit for bit (tests/test_torch_flash_tf32.py).
//
// Tiles: tf32 wgmma reads its shared-memory operands K-major only (the
// transpose bits exist for 16-bit types alone).  Every tile here is
// K-major with the 128-byte swizzle of hopper.cuh's sw128_desc: rows of
// 32 tf32 values (128 bytes) in 8-row atoms of 1,024 bytes, the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8); a K longer than 32 takes
// further box columns of rows x 128 bytes; a k8 step is 32 bytes along the
// row.  The threads stage each tile themselves (global loads into
// registers, split, swizzled stores), so any (batch, head, seq) strides
// with D contiguous are read in place and no alignment is asked; an
// operand that a product needs transposed (V for P V, Q, dO and K for the
// gradients) is written transposed at the same time.
//
// The accumulator fragment is not the A fragment: an f32 accumulator
// register pair holds columns 2t and 2t + 1 of a k8 step (t = lane % 4),
// the tf32 A fragment wants k-positions t and t + 4.  So k-position t
// stands for column 2t and t + 4 for 2t + 1, and the transposed tile
// that meets it as B stores row j of each 8-row group at k-position
// perm8(j) = j / 2 + 4 (j % 2): no shuffle.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to tf32: to nearest, ties away from zero, low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// Writes by the threads that wgmma (the async proxy) reads next: each
// writer fences, then the block meets at a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of element (row, k) of a K-major, 128-byte-swizzled tile of
// `rows` rows (box columns of 32 k apart by rows x 128 bytes).
template <int rows>
__device__ __forceinline__ uint32_t sw_off(int row, int k) {
  return (k / 32) * (rows * kSwizzleRow) + row * kSwizzleRow +
         ((((k % 32) / 4) ^ (row % 8)) << 4) + (k % 4) * 4;
}

// The k-position of row j of a transposed tile (see the header).
__device__ __forceinline__ int perm8(int j) {
  return (j & ~7) + (j % 8) / 2 + 4 * (j % 2);
}

// Element e of a thread's share of an R x D tile staged by NT threads:
// a warp covers 8 columns of 4 rows, so its global reads are 32-byte
// runs and its swizzled stores meet at most two to a bank, whether the
// tile is stored as it is or transposed.
template <int D>
__device__ __forceinline__ void tile_coords(int i, int& r, int& d) {
  constexpr int nd = D / 8;
  const int blk = i / 32;
  d = i % 8 + 8 * (blk % nd);
  r = (i / 8) % 4 + 4 * (blk / nd);
}

template <int R, int D, int NT>
struct Stage {
  static_assert(R % 4 == 0 && D % 8 == 0 && (R * D) % NT == 0,
                "a tile must split evenly over the threads");
  static constexpr int kPer = R * D / NT;  // values a thread stages
};

// Rows row0 .. row0 + R - 1 of a (seq, D) operand at `base` with row
// stride rs, rows past S as zeros, into this thread's registers.
template <int R, int D, int NT, typename T>
__device__ __forceinline__ void load_tile(float (&x)[Stage<R, D, NT>::kPer],
                                          const T* __restrict__ base,
                                          long long rs, int row0, int S,
                                          int tid) {
#pragma unroll
  for (int e = 0; e < Stage<R, D, NT>::kPer; ++e) {
    int r, d;
    tile_coords<D>(tid + e * NT, r, d);
    const int s = row0 + r;
    x[e] = s < S ? to_f32(base[s * rs + d]) : 0.f;
  }
}

// The registers of load_tile as an R-row K-major tile (hi at `hi`, lo at
// `lo`; lo only when kSplit).
template <bool kSplit, int R, int D, int NT>
__device__ __forceinline__ void put_tile(
    const float (&x)[Stage<R, D, NT>::kPer], uint8_t* hi, uint8_t* lo,
    int tid) {
#pragma unroll
  for (int e = 0; e < Stage<R, D, NT>::kPer; ++e) {
    int r, d;
    tile_coords<D>(tid + e * NT, r, d);
    const uint32_t off = sw_off<R>(r, d);
    uint32_t h, l;
    split_tf32(x[e], h, l);
    *reinterpret_cast<uint32_t*>(hi + off) = h;
    if (kSplit) *reinterpret_cast<uint32_t*>(lo + off) = l;
  }
}

// The same registers transposed: a D-row tile whose k-positions are the
// R rows, permuted by perm8.
template <bool kSplit, int R, int D, int NT>
__device__ __forceinline__ void put_tile_t(
    const float (&x)[Stage<R, D, NT>::kPer], uint8_t* hi, uint8_t* lo,
    int tid) {
#pragma unroll
  for (int e = 0; e < Stage<R, D, NT>::kPer; ++e) {
    int r, d;
    tile_coords<D>(tid + e * NT, r, d);
    const uint32_t off = sw_off<D>(d, perm8(r));
    uint32_t h, l;
    split_tf32(x[e], h, l);
    *reinterpret_cast<uint32_t*>(hi + off) = h;
    if (kSplit) *reinterpret_cast<uint32_t*>(lo + off) = l;
  }
}

// The (hi, lo) A fragments of the k8 steps of an f32 accumulator x (64
// rows x 8 kSteps columns): step j's registers are columns 2t (rows g,
// g + 8) and 2t + 1 (rows g, g + 8), at k-positions t and t + 4.
template <int kSteps>
__device__ __forceinline__ void a_fragments(const float (&x)[4 * kSteps],
                                            uint32_t (&hi)[kSteps][4],
                                            uint32_t (&lo)[kSteps][4]) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    split_tf32(x[4 * j], hi[j][0], lo[j][0]);
    split_tf32(x[4 * j + 2], hi[j][1], lo[j][1]);
    split_tf32(x[4 * j + 1], hi[j][2], lo[j][2]);
    split_tf32(x[4 * j + 3], hi[j][3], lo[j][3]);
  }
}

// ------------------------------------------------------------ tf32 wgmma
#define TF_D4 "%0, %1, %2, %3"
#define TF_D8 TF_D4 ", %4, %5, %6, %7"
#define TF_D16 TF_D8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define TF_D32                                                            \
  TF_D16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
         "%28, %29, %30, %31"
#define TF_R4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TF_R8(i) TF_R4(i), TF_R4(i + 4)
#define TF_R16(i) TF_R8(i), TF_R8(i + 8)
#define TF_R32 TF_R16(0), TF_R16(16)

// d(64 x N) (+)= a(64 x 8) b(N x 8)^T, both K-major tf32 tiles in shared
// memory; N = 2 x the registers of d.  accumulate 0 sets d.
__device__ __forceinline__ void tf32_ss(float (&d)[8], uint64_t a, uint64_t b,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {" TF_D8
      "}, %8, %9, p, 1, 1;\n}\n"
      : TF_R8(0)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void tf32_ss(float (&d)[16], uint64_t a,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" TF_D16
      "}, %16, %17, p, 1, 1;\n}\n"
      : TF_R16(0)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void tf32_ss(float (&d)[32], uint64_t a,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" TF_D32
      "}, %32, %33, p, 1, 1;\n}\n"
      : TF_R32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d(64 x N) (+)= a(64 x 8, tf32 registers, a_fragments' layout) b(N x
// 8)^T, b K-major in shared memory.
__device__ __forceinline__ void tf32_rs(float (&d)[4], const uint32_t (&a)[4],
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {" TF_D4
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : TF_R4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void tf32_rs(float (&d)[8], const uint32_t (&a)[4],
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {" TF_D8
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : TF_R8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void tf32_rs(float (&d)[16],
                                        const uint32_t (&a)[4], uint64_t b,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" TF_D16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : TF_R16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void tf32_rs(float (&d)[32],
                                        const uint32_t (&a)[4], uint64_t b,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" TF_D32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : TF_R32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef TF_R32
#undef TF_R16
#undef TF_R8
#undef TF_R4
#undef TF_D32
#undef TF_D16
#undef TF_D8
#undef TF_D4

// The 3xTF32 product of two K-major tiles: d = a b^T over kSteps k8
// steps, a at rows `a_hi`/`a_lo` (box columns a_box bytes apart), b at
// `b_hi`/`b_lo` (b_box apart).  The lo terms are summed first, then the
// hi terms; without kSplit (bf16 operands, exact in tf32) only hi hi.
// Issued, not waited for.
template <bool kSplit, int kSteps, int a_box, int b_box, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N], uint32_t a_hi,
                                         uint32_t a_lo, uint32_t b_hi,
                                         uint32_t b_lo) {
  auto at = [](uint32_t base, int kc, int box) {
    return sw128_desc(base + (kc / 4) * box + (kc % 4) * 32);
  };
  if (kSplit) {
#pragma unroll
    for (int kc = 0; kc < kSteps; ++kc)
      tf32_ss(d, at(a_hi, kc, a_box), at(b_lo, kc, b_box), kc > 0);
#pragma unroll
    for (int kc = 0; kc < kSteps; ++kc)
      tf32_ss(d, at(a_lo, kc, a_box), at(b_hi, kc, b_box), 1);
  }
#pragma unroll
  for (int kc = 0; kc < kSteps; ++kc)
    tf32_ss(d, at(a_hi, kc, a_box), at(b_hi, kc, b_box), kSplit || kc > 0);
}

// d = a b over kSteps k8 steps, a the (hi, lo) register fragments of an
// f32 accumulator (a_fragments), b a transposed tile at b_hi/b_lo (box
// columns b_box apart): lo_a hi_b, then hi_a lo_b (kSplit), then hi_a
// hi_b.  Issued, not waited for.
template <bool kSplit, int kSteps, int b_box, int N>
__device__ __forceinline__ void issue_rs(float (&d)[N],
                                         const uint32_t (&hi)[kSteps][4],
                                         const uint32_t (&lo)[kSteps][4],
                                         uint32_t b_hi, uint32_t b_lo) {
  auto at = [](uint32_t base, int kc) {
    return sw128_desc(base + (kc / 4) * b_box + (kc % 4) * 32);
  };
#pragma unroll
  for (int kc = 0; kc < kSteps; ++kc) tf32_rs(d, lo[kc], at(b_hi, kc), kc > 0);
  if (kSplit) {
#pragma unroll
    for (int kc = 0; kc < kSteps; ++kc) tf32_rs(d, hi[kc], at(b_lo, kc), 1);
  }
#pragma unroll
  for (int kc = 0; kc < kSteps; ++kc) tf32_rs(d, hi[kc], at(b_hi, kc), 1);
}

}  // namespace
