// embedding_bag: fixed-size weighted bags of table rows,
// out[b, :] = sum_k w[b, k] * table[ids[b, k], :], summed in f32 in the order
// k = 0, 1, ..., K - 1 (each product rounded to f32, then added: no FMA
// contraction, as the plain version multiplies and then sums) and written
// once in the table's dtype (f32 or bf16).
//
// Replaces src/repro/kernels/embedding_bag/kernel.py::embedding_bag_kernel
// (Pallas, TPU): the recsys lookup; DLRM's 26 single-hot features are bags
// of K = 1 with weight 1, for which the result is the row itself, bit for
// bit.  On the TPU the grid walked (bag, slot) in order, ids and weights rode
// in scalar prefetch, and an f32 VMEM accumulator carried the bag's sum
// across the K steps.  Here blocks run in no order, so nothing carries over
// between them: a group of G lanes (a power of two, at most a warp) owns one
// bag.  Lane j of the group loads id and weight k0 + j of its bag, the group
// walks the G ids in order by shuffling them out, and each lane keeps the f32
// sum of its own columns in registers.  Rows are read with the widest load
// that the row's byte width and the table's address allow: 16 bytes when
// D * sizeof(T) is a multiple of 16 (D = 128 in bf16 is 256 B, 16 lanes of
// 16 B), else 8, 4, or one element.  Row offsets are 64-bit: in a 128-wide
// table a row past 16,777,216 starts past element 2^31.
//
// Bound on an H100: bytes.  A call reads each (bag, slot)'s row, id and
// weight once and writes each bag once, B*K*(D*sizeof(T) + 8) + B*D*sizeof(T)
// bytes, for 2*B*K*D flops: under one flop a byte, far below the 295 a byte
// the tensor cores need.  The least time is those bytes over 3.35 TB/s.  The
// rows are random, so the design keeps many independent 16-byte loads in
// flight: one bag per group of lanes, 256-thread blocks, the ids of a step
// loaded by the group at once and the inner loop unrolled so that several
// row loads are issued before their sums are taken.
//
// Out-of-range ids follow one of two rules, resolved once where lane j loads
// the id (one compare and select each): clip, the rule of the Pallas kernel
// and its oracle (a negative id wraps once by V, then is clamped to
// [0, V)), and fill, the rule of jnp.take that the reference's DLRM lookups
// follow (an id in [-V, 0) wraps; any other out-of-range id reads a NaN row,
// which the sum propagates to every column of its bag).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <int VB>
struct Raw;  // an unsigned type of VB bytes, for one vector load
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};

// the row an id reads under the rule, or -1 for a NaN row (fill only)
__device__ __forceinline__ int resolve_id(int id, int V, bool fill) {
  if (id < 0) id += V;  // no overflow: V > 0
  if (fill) return id >= 0 && id < V ? id : -1;
  return min(max(id, 0), V - 1);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// VB bytes of T at p (VB-aligned), widened to f32
template <typename T, int VB>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  constexpr int kN = VB / static_cast<int>(sizeof(T));
  const typename Raw<VB>::type raw =
      *reinterpret_cast<const typename Raw<VB>::type*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kN; ++i) out[i] = to_f32(e[i]);
}

template <typename T, int VB>
__device__ __forceinline__ void store_f32(T* p, const float* in) {
  constexpr int kN = VB / static_cast<int>(sizeof(T));
  alignas(VB) T e[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) from_f32(in[i], &e[i]);
  *reinterpret_cast<typename Raw<VB>::type*>(p) =
      *reinterpret_cast<const typename Raw<VB>::type*>(e);
}

// T: table dtype; VB: bytes a load; G: lanes a bag (power of two, <= 32)
template <typename T, int VB, int G>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                     const float* __restrict__ weights, T* __restrict__ out,
                     int B, int K, int D, int V, bool fill) {
  constexpr int kVec = VB / static_cast<int>(sizeof(T));
  constexpr int kBags = kThreads / G;  // bags a block
  const int sub = threadIdx.x % G;     // lane within the bag's group
  const long long bag =
      static_cast<long long>(blockIdx.x) * kBags + threadIdx.x / G;
  const bool valid = bag < B;
  const int* bag_ids = ids + bag * K;
  const float* bag_w = weights + bag * K;
  const int chunks = D / kVec;  // vector loads a row

  // every loop bound below is uniform across the warp (K, D and G are), so
  // every lane reaches every shuffle, whether its bag is valid or not
  for (int c0 = 0; c0 < chunks; c0 += G) {
    const int c = c0 + sub;
    const bool active = valid && c < chunks;
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += G) {
      const int n = min(G, K - k0);
      int my_id = 0;
      float my_w = 0.f;
      if (valid && sub < n) {
        my_id = resolve_id(bag_ids[k0 + sub], V, fill);
        my_w = bag_w[k0 + sub];
      }
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int id = __shfl_sync(kFull, my_id, j, G);
        const float w = __shfl_sync(kFull, my_w, j, G);
        if (active) {
          float row[kVec];
          if (id >= 0) {
            load_f32<T, VB>(table + static_cast<long long>(id) * D + c * kVec,
                            row);
          } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) row[e] = __int_as_float(0x7fc00000);
          }
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(row[e], w));
        }
      }
    }
    if (active) store_f32<T, VB>(out + bag * D + c * kVec, acc);
  }
}

template <typename T, int VB, int G>
int launch(const void* table, const void* ids, const void* weights, void* out,
           int B, int K, int D, int V, bool fill, cudaStream_t stream) {
  constexpr int kBags = kThreads / G;
  const long long blocks = (static_cast<long long>(B) + kBags - 1) / kBags;
  embedding_bag_kernel<T, VB, G><<<static_cast<unsigned>(blocks), kThreads, 0,
                                   stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids),
      static_cast<const float*>(weights), static_cast<T*>(out), B, K, D, V,
      fill);
  return static_cast<int>(cudaGetLastError());
}

// G: the least power of two >= the loads a row takes, at most 32
template <typename T, int VB>
int by_lanes(const void* table, const void* ids, const void* weights,
             void* out, int B, int K, int D, int V, bool fill,
             cudaStream_t stream) {
  const int chunks = D / (VB / static_cast<int>(sizeof(T)));
  if (chunks <= 1)
    return launch<T, VB, 1>(table, ids, weights, out, B, K, D, V, fill,
        stream);
  if (chunks <= 2)
    return launch<T, VB, 2>(table, ids, weights, out, B, K, D, V, fill,
        stream);
  if (chunks <= 4)
    return launch<T, VB, 4>(table, ids, weights, out, B, K, D, V, fill,
        stream);
  if (chunks <= 8)
    return launch<T, VB, 8>(table, ids, weights, out, B, K, D, V, fill,
        stream);
  if (chunks <= 16)
    return launch<T, VB, 16>(table, ids, weights, out, B, K, D, V, fill,
        stream);
  return launch<T, VB, 32>(table, ids, weights, out, B, K, D, V, fill,
        stream);
}

// the widest load (16, 8, 4 bytes or one element) that divides the row's
// byte width and both base addresses, so every row and output row is aligned
template <typename T>
int by_width(const void* table, const void* ids, const void* weights,
             void* out, int B, int K, int D, int V, bool fill,
             cudaStream_t stream) {
  const unsigned long long row = static_cast<unsigned long long>(D) * sizeof(T);
  const unsigned long long a = row | reinterpret_cast<uintptr_t>(table) |
                               reinterpret_cast<uintptr_t>(out);
  if (a % 16 == 0)
    return by_lanes<T, 16>(table, ids, weights, out, B, K, D, V, fill,
        stream);
  if (a % 8 == 0)
    return by_lanes<T, 8>(table, ids, weights, out, B, K, D, V, fill,
        stream);
  if (a % 4 == 0)
    return by_lanes<T, 4>(table, ids, weights, out, B, K, D, V, fill,
        stream);
  if constexpr (sizeof(T) == 2) {
    if (a % 2 == 0)
      return by_lanes<T, 2>(table, ids, weights, out, B, K, D, V, fill,
        stream);
  }
  return static_cast<int>(cudaErrorMisalignedAddress);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  table: (V, D) contiguous; ids: (B, K) int32,
// any value (rule: 0 clip, 1 fill); weights: (B, K) float32; out: (B, D) in
// the table's dtype.
extern "C" int embedding_bag(const void* table, const void* ids,
                             const void* weights, void* out, int dtype, int B,
                             int K, int D, int V, int rule, void* stream) {
  if (B <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (K < 0 || V <= 0 || (rule != 0 && rule != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const bool fill = rule == 1;
  if (dtype == 0)
    return by_width<float>(table, ids, weights, out, B, K, D, V, fill, st);
  if (dtype == 1)
    return by_width<__nv_bfloat16>(table, ids, weights, out, B, K, D, V, fill,
                                   st);
  return static_cast<int>(cudaErrorInvalidValue);
}
