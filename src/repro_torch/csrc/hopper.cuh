// hopper.cuh: the Hopper (sm_90a) building blocks that the port's wgmma
// kernels share: mbarriers, TMA tensor and bulk copies, the 128-byte
// swizzle's shared-memory descriptor, wgmma, and the host's tensor-map
// encoder.  Included by flash_attention_wgmma.cu (the forward) and
// flash_attention_bwd.cu (the backward); cuda_lib.py hashes csrc/*.cuh
// into the library's name, so an edited header rebuilds both.
//
// Everything here has internal linkage (an unnamed namespace): each
// including source compiles its own copy.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBox = 64;                    // bf16 columns of one 128-byte box row
constexpr int kSwizzleRow = 128;            // bytes of one swizzled tile row
constexpr uint32_t kSpinLimit = 1u << 28;   // a stalled ring traps, not hangs

struct Strides {
  long long b, h, s;  // elements; D is contiguous
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == kSpinLimit) __trap();
  }
}

// --------------------------------------------------------------------- TMA
// One box of a 4-d tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) from a 16-byte aligned global address into
// shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle; lbo and sbo in 16-byte
// units.  K-major tiles: 8-row groups 1,024 B apart (sbo 64), lbo unused; a
// k16 step is 32 B along the row (a new 64-column box past the fourth).
// MN-major tiles (64 columns of N): 8-row groups of K 1,024 B apart (sbo
// 64); a k16 step is 16 rows, 2,048 B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) | (static_cast<uint64_t>(64) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Keeps the compiler from touching accumulator registers across a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The operand lists of an accumulator of 16, 32 or 64 f32 registers.
#define WG_D16                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_D32                                                             \
  WG_D16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
         "%28, %29, %30, %31"
#define WG_D64                                                             \
  WG_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
         "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "    \
         "%56, %57, %58, %59, %60, %61, %62, %63"
#define WG_R4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_R16(i) WG_R4(i), WG_R4(i + 4), WG_R4(i + 8), WG_R4(i + 12)
#define WG_R32 WG_R16(0), WG_R16(16)
#define WG_R64 WG_R32, WG_R16(32), WG_R16(48)

// d(64 x N) (+)= a(64 x 16) b(N x 16)^T, both K-major in shared memory;
// N = 2 x the registers of d (32, 64 or 128).  accumulate 0 sets d.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_D16
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_R16(0)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_R32
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_D64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_R64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d(64 x 64) (+)= a(64 x 16, bf16 registers) b(16 x 64), b MN-major in
// shared memory (transposed).  a is laid out as the f32 accumulator
// fragment of a k16 chunk: register q packs columns c, c + 1 of row r
// (q even) or r + 8 (q odd), 8 columns further for q >= 2.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_R32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef WG_R64
#undef WG_R32
#undef WG_R16
#undef WG_R4
#undef WG_D64
#undef WG_D32
#undef WG_D16

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as a bf16 pair hi = bf16(x, y) and lo = bf16 of the remainder:
// hi + lo keeps 16 bits of x and y where hi alone keeps 8.
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time so the library needs no
// -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (B, heads, S, D) bf16 operand as a 4-d map (D, S, heads, B) with boxes
// of 64 x box_rows x 1 x 1, 128-byte swizzled; rows past S arrive as
// zeros.  A dim of size 1 is never stepped, so its stride is given as 16
// bytes whatever the tensor says.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B,
            int heads, int S, int D, Strides st, int box_rows) {
  auto stride = [](int n, long long s) {
    return static_cast<cuuint64_t>(n > 1 ? s * 2 : 16);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {stride(S, st.s), stride(heads, st.h),
                                 stride(B, st.b)};
  const cuuint32_t box[4] = {kBox, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
