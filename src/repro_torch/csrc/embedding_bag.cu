// embedding_bags: fixed-size weighted bags of T tables' rows in one launch,
// out[t, b, :] = sum_k w[t, b, k] * table_t[ids[t, b, k], :], summed in f32
// in the order k = 0, 1, ..., K - 1 (each product rounded to f32, then
// added: no FMA contraction, as the plain version multiplies and then sums),
// rounded to the tables' dtype (f32 or bf16) and then converted to the
// output's (f32 or bf16).  A bf16 table written into an f32 buffer, or an
// f32 table into a bf16 one, so gives what the one-table bag cast to that
// dtype gives, bit for bit.
//
// Replaces src/repro/kernels/embedding_bag/kernel.py::embedding_bag_kernel
// (Pallas, TPU): the recsys lookup; DLRM's 26 single-hot features are bags
// of K = 1 with weight 1, for which the result is the row itself, bit for
// bit.  On the TPU the grid walked (bag, slot) in order, ids and weights rode
// in scalar prefetch, and an f32 VMEM accumulator carried the bag's sum
// across the K steps; the reference's DLRM takes 26 gathers and a stack that
// XLA fuses.  Here one launch serves every table of a DLRM forward and
// writes each bag into its slot of the interaction's input: the tables'
// pointers and row counts ride in the kernel's parameters (a struct passed
// by value, no copy to the device), and ids, weights and output are read and
// written through a table stride and a bag stride, so the caller's (B, 26)
// ids need no transposed copy and the bags land in a (B, 27, D) buffer.
//
// Bound on an H100: bytes.  A call reads each distinct row it resolves once,
// each id and weight once and writes each bag once, for 2*T*B*K*D flops:
// under one flop a byte, far below the 295 a byte the tensor cores need.
// The rows are random, so the time is the latency of dependent loads unless
// many are in flight.  The design:
//   * lanes map onto (bag, chunk) pairs: a row of D * sizeof(T) bytes is
//     read in C chunks of the widest load (16, 8, 4 bytes or one element)
//     that the row width and every address allow; a bag takes G = min(C, 32)
//     lanes and a warp holds P = 32 / G bags at once (D 128 in bf16: 16
//     lanes, 2 bags; D 18 in bf16: 9 lanes of 4 bytes, 3 bags, 27 lanes
//     busy), and a row wider than 32 chunks is walked 32 chunks at a time;
//   * a lane group owns nb = max(1, R / K) bags, nb * K (bag, slot) items
//     walked R at a time (G less G % kRows, so a round is whole steps):
//     lane i of the group loads item i's id and weight (one coalesced load
//     each, read-only path), the next R items' are loaded before this
//     round's rows, and shuffles hand the ids to the
//     group's lanes; kRows rows are then loaded at once (read-only path; an
//     id that reads no row loads row 0, unused) before any sum is taken, and
//     added in order k = 0..K-1, a bag stored when its last slot is in.
//     kRows is 4 rows of 16-byte loads, 8 of narrower ones: 64 bytes of
//     rows a lane, so a thread keeps to 64 registers and 32 warps fit an
//     SM.  K = 1 keeps 4 16-byte loads a lane in flight behind one id load
//     for 16 bags (D 128 in bf16), where a lane had one load behind one id
//     load before; DIN's 36-byte rows keep 8 in flight;
//   * block i works on table i % T and bag tile i / T, so the T blocks of
//     one bag tile run side by side: a (B, T) id matrix read with a bag
//     stride of T is fetched from HBM once and its other reads hit L2, and
//     the (B, T + 1, D) output is written a tile of whole bag rows at a time.
// Row offsets are 64-bit: in a 128-wide table a row past 16,777,216 starts
// past element 2^31.
//
// Out-of-range ids follow one of two rules, resolved once where an id is
// loaded (one compare and select each): clip, the rule of the Pallas kernel
// and its oracle (a negative id wraps once by V, then is clamped to
// [0, V)), and fill, the rule of jnp.take that the reference's DLRM lookups
// follow (an id in [-V, 0) wraps; any other out-of-range id reads a NaN row,
// which the sum propagates to every column of its bag).
//
// A row window: each table may be one rank's block of a table whose rows
// are split over a mesh, rows [first, first + rows) of a whole table of V
// rows.  Ids resolve against V under the rule; an id that lands in the
// whole table but outside the block adds nothing to its bag (the rank that
// holds its row adds it, and the ranks' partial bags are summed outside the
// kernel), and an id outside the whole table gives NaN under fill on every
// rank.  With first 0 and V = rows every result is the unwindowed one, bit
// for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTables = 64;   // tables a launch
constexpr int kMinBlocks = 4;    // blocks an SM holds: at most 64 registers

// row loads a lane issues before it takes any sum, for loads of vb bytes:
// 64 bytes of rows in registers, at most 8 rows
__host__ __device__ constexpr int rows_a_step(int vb) {
  return vb >= 16 ? 4 : 8;
}

// what an id resolves to besides a row of the block
constexpr int kNanRow = -1;  // outside the whole table under fill: NaN
constexpr int kNoRow = -2;   // in the whole table, outside the block: nothing

// everything a launch reads, passed by value as the kernel's parameter
struct Bags {
  const void* table[kMaxTables];  // (rows[t], D) contiguous, one dtype
  int rows[kMaxTables];           // the block's rows
  int first[kMaxTables];          // the block's first row in its whole table
  int whole[kMaxTables];          // the whole table's rows: ids resolve on it
  int n_tables;
  const int* ids;                 // ids[t * ids_table + b * ids_bag + k]
  long long ids_table, ids_bag;
  const float* weights;           // the same with w_table, w_bag; 0: shared
  long long w_table, w_bag;
  void* out;                      // out[t * out_table + b * out_bag + d]
  long long out_table, out_bag;
  int B, K, D;
  int nb;                         // bags a lane group owns
  bool fill;                      // the id rule: fill, else clip
};

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

// the row of the block [first, first + n) of a V-row table that an id
// reads under the rule, kNanRow for a NaN row (fill only) or kNoRow for a
// row of the table outside the block
__device__ __forceinline__ int resolve_id(int id, int V, int first, int n,
                                          bool fill) {
  if (id < 0) id += V;  // no overflow: V > 0
  if (fill) {
    if (id < 0 || id >= V) return kNanRow;
  } else {
    id = min(max(id, 0), V - 1);
  }
  id -= first;  // no overflow: 0 <= id, first < V
  return id >= 0 && id < n ? id : kNoRow;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// an f32 sum rounded to the table's dtype T, then converted to the output's
// dtype O (round to nearest even, as torch's casts)
template <typename T, typename O>
__device__ __forceinline__ O round_to(float x);
template <>
__device__ __forceinline__ float round_to<float, float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16
round_to<__nv_bfloat16, __nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16
round_to<float, __nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16, float>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// kVec elements of T in one VB-byte load, widened to f32
template <typename T, int VB>
__device__ __forceinline__ void widen(const typename Raw<VB>::type& raw,
                                      float* out) {
  constexpr int kVec = VB / static_cast<int>(sizeof(T));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) out[i] = to_f32(e[i]);
}

// kVec sums rounded and stored at p, at most 16 bytes a store (p is aligned
// to the store's width)
template <typename T, typename O, int kVec>
__device__ __forceinline__ void store_sums(O* p, const float* acc) {
  constexpr int kBytes = kVec * static_cast<int>(sizeof(O));
  constexpr int kPiece = kBytes < 16 ? kBytes : 16;
  using Piece = typename Raw<kPiece>::type;
  alignas(16) O e[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) e[i] = round_to<T, O>(acc[i]);
#pragma unroll
  for (int b = 0; b < kBytes; b += kPiece)
    *reinterpret_cast<Piece*>(reinterpret_cast<char*>(p) + b) =
        *reinterpret_cast<const Piece*>(reinterpret_cast<const char*>(e) + b);
}

// the row an item reads, and its weight: item i of a lane group is slot
// i % K of its bag i / K; an item past the group's last bag reads nothing
__device__ __forceinline__ void fetch(const Bags& p, const int* ids,
                                      const float* weights, long long first,
                                      int P, int item, int live, int t,
                                      int& id, float& w) {
  id = 0;
  w = 0.f;
  if (item < live) {
    const int j = item / p.K, k = item - j * p.K;
    const long long bag = first + static_cast<long long>(j) * P;
    id = resolve_id(__ldg(ids + bag * p.ids_bag + k), p.whole[t], p.first[t],
                    p.rows[t], p.fill);
    w = __ldg(weights + bag * p.w_bag + k);
  }
}

// T: the tables' dtype; O: the output's; VB: bytes a row load
template <typename T, typename O, int VB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
embedding_bags_kernel(const __grid_constant__ Bags p) {
  using Load = typename Raw<VB>::type;
  constexpr int kVec = VB / static_cast<int>(sizeof(T));
  constexpr int kRows = rows_a_step(VB);
  const int chunks = p.D / kVec;               // loads a row
  const int G = chunks < 32 ? chunks : 32;     // lanes a bag
  const int P = 32 / G;                        // bags a warp holds at once
  const int R = G < kRows ? G : G - G % kRows;  // items a round: whole steps
  const int lane = threadIdx.x % 32;
  if (lane >= P * G) return;  // an idle lane: outside every shuffle's mask
  const unsigned mask = P * G == 32 ? 0xffffffffu : (1u << (P * G)) - 1u;
  const int s = lane / G, sub = lane - s * G, src0 = s * G;
  const int t = static_cast<int>(blockIdx.x % p.n_tables);
  const long long tile = blockIdx.x / p.n_tables;
  // the lane group's bags are first + j * P, j = 0 .. nb - 1
  const long long first =
      (tile * kWarps + threadIdx.x / 32) * P * p.nb + s;
  const T* table = static_cast<const T*>(p.table[t]);
  const int K = p.K, D = p.D;
  const int* ids = p.ids + t * p.ids_table;
  const float* weights = p.weights + t * p.w_table;
  O* out = static_cast<O*>(p.out) + t * p.out_table;
  // (bag, slot) items, bag-major: every group of a warp walks all of them
  // (the shuffles need the whole mask), only those of bags < B count
  const int items = p.nb * K;
  const long long left = first < p.B ? (p.B - first + P - 1) / P : 0;
  const int live = static_cast<int>(left < p.nb ? left : p.nb) * K;

  for (int c0 = 0; c0 < chunks; c0 += G) {  // one round unless chunks > 32
    const int c = c0 + sub;
    const int cl = c < chunks ? c : chunks - 1;  // a column every lane loads
    float acc[kVec];
    if (K == 0) {  // empty bags sum to 0
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
      for (long long j = 0; j < left && j < p.nb; ++j)
        if (c < chunks)
          store_sums<T, O, kVec>(out + (first + j * P) * p.out_bag + c * kVec,
                                 acc);
      continue;
    }
    // lane sub < R holds item i0 + sub of each round of R items; the next
    // round's id and weight are loaded before this round's rows
    int id_next;
    float w_next;
    fetch(p, ids, weights, first, P, sub < R ? sub : items, live, t, id_next,
          w_next);
    for (int i0 = 0; i0 < items; i0 += R) {
      const int my_id = id_next;
      const float my_w = w_next;
      if (i0 + R < items)
        fetch(p, ids, weights, first, P, sub < R ? i0 + R + sub : items, live,
              t, id_next, w_next);
      const int n = min(R, items - i0);
      int j = i0 / K, k = i0 - j * K;
      for (int u0 = 0; u0 < n; u0 += kRows) {
        int id[kRows];
        float w[kRows];
        Load raw[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int src = src0 + min(u0 + u, n - 1);
          id[u] = __shfl_sync(mask, my_id, src);
          w[u] = __shfl_sync(mask, my_w, src);
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u)  // every row load of the step
          raw[u] = __ldg(reinterpret_cast<const Load*>(
              table + static_cast<long long>(max(id[u], 0)) * D + cl * kVec));
#pragma unroll
        for (int u = 0; u < kRows; ++u) {  // then the sums, k in order
          if (u0 + u < n && i0 + u0 + u < live && c < chunks) {
            if (k == 0) {
#pragma unroll
              for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
            }
            if (id[u] != kNoRow) {  // a row outside the block adds nothing
              float row[kVec];
              widen<T, VB>(raw[u], row);
#pragma unroll
              for (int e = 0; e < kVec; ++e) {
                if (id[u] == kNanRow) row[e] = __int_as_float(0x7fc00000);
                acc[e] = __fadd_rn(acc[e], __fmul_rn(row[e], w[u]));
              }
            }
            if (k == K - 1)
              store_sums<T, O, kVec>(
                  out + (first + static_cast<long long>(j) * P) * p.out_bag +
                      c * kVec,
                  acc);
          }
          if (++k == K) k = 0, ++j;
        }
      }
    }
  }
}

template <typename T, typename O, int VB>
int launch(Bags& p, cudaStream_t stream) {
  constexpr int kVec = VB / static_cast<int>(sizeof(T));
  constexpr int kRows = rows_a_step(VB);
  const int chunks = p.D / kVec;
  const int P = chunks < 32 ? 32 / chunks : 1;
  const int G = chunks < 32 ? chunks : 32;
  const int R = G < kRows ? G : G - G % kRows;
  p.nb = p.K == 0 ? R : (p.K <= R ? R / p.K : 1);
  const long long per_block = static_cast<long long>(kWarps) * P * p.nb;
  const long long blocks = (p.B + per_block - 1) / per_block * p.n_tables;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  embedding_bags_kernel<T, O, VB>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the widest row load (16, 8, 4 bytes or one element) that divides the row's
// byte width and every table's address, and whose store (VB * sizeof(O) /
// sizeof(T) bytes, at most 16 a store) the output's address and strides
// keep aligned
template <typename T, typename O>
int by_width(Bags& p, cudaStream_t stream) {
  unsigned long long tab = static_cast<unsigned long long>(p.D) * sizeof(T);
  for (int t = 0; t < p.n_tables; ++t)
    tab |= reinterpret_cast<uintptr_t>(p.table[t]);
  const unsigned long long out =
      reinterpret_cast<uintptr_t>(p.out) |
      static_cast<unsigned long long>(p.out_table) * sizeof(O) |
      static_cast<unsigned long long>(p.out_bag) * sizeof(O);
  auto fits = [&](unsigned long long vb) {
    const unsigned long long store = vb * sizeof(O) / sizeof(T);
    return tab % vb == 0 && out % (store < 16 ? store : 16) == 0;
  };
  if (fits(16)) return launch<T, O, 16>(p, stream);
  if (fits(8)) return launch<T, O, 8>(p, stream);
  if (fits(4)) return launch<T, O, 4>(p, stream);
  if constexpr (sizeof(T) == 2) {
    if (fits(2)) return launch<T, O, 2>(p, stream);
  }
  return static_cast<int>(cudaErrorMisalignedAddress);
}

template <typename T>
int by_out(Bags& p, int out_dtype, cudaStream_t stream) {
  if (out_dtype == 0) return by_width<T, float>(p, stream);
  if (out_dtype == 1) return by_width<T, __nv_bfloat16>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// tables: a host array of n_tables device pointers, each a (rows[t], D)
// contiguous table in table_dtype (0 float32, 1 bfloat16); rows: a host
// array of their row counts; first and whole: host arrays of each table's
// window, its first row in a whole table of whole[t] rows (0 and rows[t]
// for a table that is whole).  ids: int32, any value (rule: 0 clip, 1 fill),
// ids[t * ids_table_stride + b * ids_bag_stride + k] for k < K; weights:
// float32 with its own strides (0 shares); out: out_dtype, bag (t, b) at
// t * out_table_stride + b * out_bag_stride, D contiguous elements.
// Strides count elements.
extern "C" int embedding_bags(const void* tables, const void* rows,
                              const void* first, const void* whole,
                              int n_tables, const void* ids,
                              long long ids_table_stride,
                              long long ids_bag_stride, const void* weights,
                              long long weights_table_stride,
                              long long weights_bag_stride, void* out,
                              long long out_table_stride,
                              long long out_bag_stride, int table_dtype,
                              int out_dtype, int B, int K, int D, int rule,
                              void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (K < 0 || (rule != 0 && rule != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Bags p{};
  for (int t = 0; t < n_tables; ++t) {
    p.table[t] = static_cast<const void* const*>(tables)[t];
    p.rows[t] = static_cast<const int*>(rows)[t];
    p.first[t] = static_cast<const int*>(first)[t];
    p.whole[t] = static_cast<const int*>(whole)[t];
    if (p.rows[t] <= 0 || p.first[t] < 0 ||
        p.first[t] > p.whole[t] - p.rows[t])
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.n_tables = n_tables;
  p.ids = static_cast<const int*>(ids);
  p.ids_table = ids_table_stride;
  p.ids_bag = ids_bag_stride;
  p.weights = static_cast<const float*>(weights);
  p.w_table = weights_table_stride;
  p.w_bag = weights_bag_stride;
  p.out = out;
  p.out_table = out_table_stride;
  p.out_bag = out_bag_stride;
  p.B = B;
  p.K = K;
  p.D = D;
  p.fill = rule == 1;
  auto st = static_cast<cudaStream_t>(stream);
  if (table_dtype == 0) return by_out<float>(p, out_dtype, st);
  if (table_dtype == 1) return by_out<__nv_bfloat16>(p, out_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
