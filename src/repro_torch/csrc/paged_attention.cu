// paged_attention: one-token decode attention through a block table,
// o[b, h] = softmax(q[b, h] K_b^T / sqrt(D)) V_b, where K_b and V_b are the
// first lengths[b] rows of the pages block_table[b, :] of a shared
// (n_pages, page, D) pool with no head axis (every head of row b reads the
// same K/V).  m, l and the accumulator are f32; the output is written in
// the input dtype (f32 or bf16).  On request it also writes each row and
// head's log-sum-exp, lse[b, h] = ln sum_t exp(q[b, h] . k_t / sqrt(D)) over
// the row's valid tokens in f32 (kLseEmpty for a row of length 0), so that
// callers holding a row's tokens in several blocks can merge their outputs.
//
// Replaces src/repro/kernels/paged_attention/kernel.py::paged_attention_kernel
// (Pallas, TPU): the decode attention of the LM serving path.  On the TPU the
// table and lengths rode in scalar prefetch and the grid walked
// (row, page) in order with the online-softmax state in VMEM scratch.
//
// Bound on an H100: bytes.  Each step reads the K and V rows below the
// lengths once (2 * sum(lengths) * D * sizeof(T)) and does 4 * D flops per
// row, head and token, far under the 295 flops a byte the tensor cores need;
// the least time is those bytes over 3.35 TB/s.  Reaching it takes many
// bytes in flight on every SM, so the design is about memory parallelism.
//
// Split-KV.  The grid is (rows, head groups of up to 8 heads, splits): a
// split owns split_pages consecutive entries of a row's table, a choice the
// wrapper makes from static shapes alone (kernel.py::paged_split) so that a
// full-length launch has several blocks resident on each SM.  A split that
// lies wholly past lengths[b] exits at once; a row of one split writes its
// output directly.  A block first stages its slice of the table in shared
// memory, so no K/V load waits on a dependent load of its page id.
//
// Loads in flight: multi-stage cp.async.  A pass of the block's 128 threads
// covers kPass tokens: the lanes of a warp form groups of D * sizeof(T) / 16
// lanes, and each lane owns one 16-byte piece of one token's K row and the
// same piece of its V row (2 KB of K and 2 KB of V a pass, for every D and
// dtype).  Each thread copies its own pieces of up to kStages passes into a
// shared-memory ring with 16-byte cp.async, ahead of the arithmetic,
// and reads back only what it copied itself, so the ring needs no block
// barrier.  The arithmetic takes two passes a step: two scores a lane
// group, one rescale of its state (three exp2s for two tokens, scores in
// log2 units).  Chosen over Hopper's bulk copy (cp.async.bulk with mbarriers)
// because a pass's tokens may span several pages (pages of 1 to 16 tokens)
// or end inside one (the length's tail), which per-thread copies of the
// rows below the length handle with no per-page bookkeeping, and the copies
// a thread issues are the ones it waits for.
//
// Combine.  Each lane group keeps its own online-softmax state; the groups
// of a warp merge by shuffles and the warps through shared memory.  A split
// of a row of several splits writes its (m, l, acc) in f32 to the wrapper's
// scratch, then takes a ticket (an atomic counter per row and head group);
// the block that takes the last ticket resets the counter for the next
// launch and merges the partials in split order (their loads unrolled, so
// several are in flight), so the result does not depend on which block
// finishes last, and a layer stays one launch.
//
// Log-sum-exp.  The block that writes a (row, head)'s output holds its
// merged running max m (log2 units) and sum l, so the log-sum-exp is one
// more store, ln 2 * (m + log2 l), by the thread of d = 0; a null lse skips
// it, and the output is the same either way.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 8;            // the ring's depth in passes (even)
constexpr int kMaxSplitPages = 256;   // table slice in shared memory
constexpr float kNegInf = -1e30f;     // the reference's initial running max
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the log-sum-exp of a row of length 0: finite, so that a merge weighs it
// exp(kLseEmpty - max) = 0 beside any real row (the plain version's too)
constexpr float kLseEmpty = -1e30f;

template <typename T>
struct Vec;  // one 16-byte piece of a row of T, widened to f32

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void widen(uint4 raw, float* out) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void widen(uint4 raw, float* out) {
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pairs[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int D, int HG>
struct Shape {
  static constexpr int kVec = Vec<T>::kN;      // elements of a 16-byte piece
  static constexpr int kLanes = D / kVec;      // lanes reading one token
  static constexpr int kTokens = 32 / kLanes;  // tokens of a warp a pass
  static constexpr int kPass = kWarps * kTokens;
  static_assert(D % kVec == 0 && kLanes <= 32 && 32 % kLanes == 0,
                "D * sizeof(T) must be 16, 32, ..., 512 bytes");
};

// the state (om, ol, oacc) merged into (m, l, acc); m in log2 units
__device__ __forceinline__ void merge(float& m, float& l, float* acc, int n,
                                      float om, float ol, const float* oacc) {
  const float mn = fmaxf(m, om);
  const float a = exp2f(m - mn), b = exp2f(om - mn);
  l = l * a + ol * b;
  for (int e = 0; e < n; ++e) acc[e] = acc[e] * a + oacc[e] * b;
  m = mn;
}

template <typename T, int D, int HG>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ table,
                       const int* __restrict__ lengths, T* __restrict__ o,
                       float* __restrict__ lse, float* __restrict__ part,
                       int* __restrict__ tickets,
                       int H, int page, int max_pages, int split_pages,
                       float scale) {
  using S = Shape<T, D, HG>;
  constexpr int kVec = S::kVec;
  constexpr int kLanes = S::kLanes;
  constexpr int kTokens = S::kTokens;
  constexpr int kPart = HG * (D + 2);  // floats of one split's state
  __shared__ int sm_pages[kMaxSplitPages];
  __shared__ union {
    uint4 ring[kStages][2][kThreads];  // the passes in flight
    float acc[kWarps][HG][D];          // then the warps' accumulators
  } sm;
  __shared__ float sm_m[kWarps][HG], sm_l[kWarps][HG];
  __shared__ int sm_last;

  const int row = blockIdx.x;
  const int group = blockIdx.y;
  const int split = blockIdx.z;
  const int n_groups = gridDim.y;
  const int n_splits = gridDim.z;
  const int h0 = group * HG;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / kLanes;  // token slot of this lane's group
  const int c = lane % kLanes;  // its piece of D
  const int len = max(0, min(lengths[row], max_pages * page));
  const int split_tokens = split_pages * page;
  const int active = (len + split_tokens - 1) / split_tokens;
  const float scale2 = scale * kLog2e;  // scores in log2 units
  T* orow = o + (static_cast<long long>(row) * H + h0) * D;
  float* lrow =
      lse == nullptr ? nullptr : lse + static_cast<long long>(row) * H + h0;

  if (active == 0) {  // an empty row reads nothing and yields zeros
    if (split == 0) {
      for (int i = tid; i < HG * D; i += kThreads)
        if (h0 + i / D < H) store(orow + i, 0.f);
      if (lrow != nullptr && tid < HG && h0 + tid < H) lrow[tid] = kLseEmpty;
    }
    return;
  }
  if (split >= active) return;

  const int t_begin = split * split_tokens;
  const int t_end = min(len, t_begin + split_tokens);
  const int p0 = split * split_pages;
  const int n_pages = (t_end - 1) / page - p0 + 1;
  const int* trow = table + static_cast<long long>(row) * max_pages + p0;
  for (int i = tid; i < n_pages; i += kThreads) sm_pages[i] = trow[i];

  float qv[HG][kVec];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    const bool ok = h0 + h < H;
    const T* qh = q + (static_cast<long long>(row) * H + h0 + h) * D + c * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) qv[h][e] = ok ? to_f32(qh[e]) : 0.f;
  }
  float m[HG], l[HG], acc[HG][kVec];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[h][e] = 0.f;
  }
  __syncthreads();  // the table slice

  const int slot = warp * kTokens + g;  // this lane's token within a pass
  const int n_pass = (t_end - t_begin + S::kPass - 1) / S::kPass;
  // the next pass to issue: its token's table entry (within the slice)
  // and row within the page, stepped without a division a pass
  const int step_pages = S::kPass / page, step_rows = S::kPass % page;
  int next_entry = (t_begin + slot) / page - p0;
  int next_row = (t_begin + slot) % page;
  auto issue = [&](int pass) {
    const int t = t_begin + pass * S::kPass + slot;
    if (pass < n_pass && t < t_end) {
      const long long off =
          (static_cast<long long>(sm_pages[next_entry]) * page + next_row) *
              D +
          c * kVec;
      cp_async16(&sm.ring[pass % kStages][0][tid], k_pool + off);
      cp_async16(&sm.ring[pass % kStages][1][tid], v_pool + off);
    }
    cp_async_commit();  // an empty group keeps the count of groups
    next_entry += step_pages;
    next_row += step_rows;
    if (next_row >= page) {
      next_row -= page;
      ++next_entry;
    }
  };
  // this thread's score of the token of `pass` it read (log2 units), or
  // -inf past the split's end; kf, vf its K and V pieces
  auto score = [&](int pass, float (&kf)[kVec], float (&vf)[kVec],
                   float (&s)[HG]) {
    const bool ok = t_begin + pass * S::kPass + slot < t_end;
    if (ok) {
      Vec<T>::widen(sm.ring[pass % kStages][0][tid], kf);
      Vec<T>::widen(sm.ring[pass % kStages][1][tid], vf);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      float x = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) x += qv[h][e] * kf[e];
#pragma unroll
      for (int w = kLanes / 2; w > 0; w >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, w);
      s[h] = ok ? x * scale2 : -INFINITY;
    }
  };
#pragma unroll
  for (int p = 0; p < kStages - 2; ++p) issue(p);

  // two passes a step, one rescale of the state for both; a warp-uniform
  // loop, so every lane reaches the shuffles
  for (int pass = 0; pass < n_pass; pass += 2) {
    issue(pass + kStages - 2);
    issue(pass + kStages - 1);
    cp_async_wait<kStages - 2>();  // this thread's pieces of both landed
    float ka[kVec], va[kVec], kb[kVec], vb[kVec], sa[HG], sb[HG];
    score(pass, ka, va, sa);
    score(pass + 1, kb, vb, sb);
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      const float m_new = fmaxf(m[h], fmaxf(sa[h], sb[h]));
      const float corr = exp2f(m[h] - m_new);
      const float pa = exp2f(sa[h] - m_new), pb = exp2f(sb[h] - m_new);
      l[h] = l[h] * corr + pa + pb;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[h][e] = acc[h][e] * corr + pa * va[e] + pb * vb[e];
      m[h] = m_new;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring

  // merge the lane groups of each warp (same piece c, other tokens)
#pragma unroll
  for (int w = kLanes; w < 32; w <<= 1) {
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      const float om = __shfl_xor_sync(0xffffffffu, m[h], w);
      const float ol = __shfl_xor_sync(0xffffffffu, l[h], w);
      float oacc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        oacc[e] = __shfl_xor_sync(0xffffffffu, acc[h][e], w);
      merge(m[h], l[h], acc[h], kVec, om, ol, oacc);
    }
  }
  if (g == 0) {
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      if (c == 0) {
        sm_m[warp][h] = m[h];
        sm_l[warp][h] = l[h];
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) sm.acc[warp][h][c * kVec + e] = acc[h][e];
    }
  }
  __syncthreads();

  // merge the warps: this split's state, element (h, d) by thread
  float* my_part =
      part + ((static_cast<long long>(row) * n_groups + group) * n_splits +
              split) * kPart;
  for (int i = tid; i < HG * D; i += kThreads) {
    const int h = i / D, d = i % D;
    if (h0 + h >= H) continue;
    float mx = sm_m[0][h], den = sm_l[0][h], num = sm.acc[0][h][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      merge(mx, den, &num, 1, sm_m[w][h], sm_l[w][h], &sm.acc[w][h][d]);
    if (active == 1) {
      store(orow + i, num / fmaxf(den, 1e-30f));
      if (lrow != nullptr && d == 0) lrow[h] = kLn2 * (mx + log2f(den));
    } else {
      if (d == 0) {
        my_part[h * (D + 2)] = mx;
        my_part[h * (D + 2) + 1] = den;
      }
      my_part[h * (D + 2) + 2 + d] = num;
    }
  }
  if (active == 1) return;

  // the last split of this (row, head group) to finish combines them all
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // this block's partials before its ticket
    int* ticket = tickets + static_cast<long long>(row) * n_groups + group;
    const int taken = atomicAdd(ticket, 1);
    sm_last = taken == active - 1;
    if (sm_last) {
      atomicExch(ticket, 0);
      __threadfence();  // the others' partials after their tickets
    }
  }
  __syncthreads();
  if (!sm_last) return;
  const float* parts =
      part + (static_cast<long long>(row) * n_groups + group) * n_splits * kPart;
  for (int i = tid; i < HG * D; i += kThreads) {
    const int h = i / D, d = i % D;
    if (h0 + h >= H) continue;
    float mx = kNegInf, den = 0.f, num = 0.f;
#pragma unroll 8
    for (int s = 0; s < active; ++s) {  // in split order
      const float* ps = parts + s * kPart + h * (D + 2);
      const float ps_acc = __ldcg(ps + 2 + d);
      merge(mx, den, &num, 1, __ldcg(ps), __ldcg(ps + 1), &ps_acc);
    }
    store(orow + i, num / fmaxf(den, 1e-30f));
    if (lrow != nullptr && d == 0) lrow[h] = kLn2 * (mx + log2f(den));
  }
}

template <typename T, int D, int HG>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* lengths, void* o, void* lse,
           void* part, void* tickets, int B, int H, int page, int max_pages,
           int split_pages, float scale, cudaStream_t stream) {
  const int n_splits = (max_pages + split_pages - 1) / split_pages;
  const dim3 grid(static_cast<unsigned>(B),
                  static_cast<unsigned>((H + HG - 1) / HG),
                  static_cast<unsigned>(n_splits));
  paged_attention_kernel<T, D, HG><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(o),
      static_cast<float*>(lse), static_cast<float*>(part),
      static_cast<int*>(tickets), H, page, max_pages, split_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_heads(int H, const void* q, const void* k_pool, const void* v_pool,
             const void* table, const void* lengths, void* o, void* lse,
             void* part, void* tickets, int B, int page, int max_pages,
             int split_pages, float scale, cudaStream_t stream) {
  if (H <= 1)
    return launch<T, D, 1>(q, k_pool, v_pool, table, lengths, o, lse, part,
                           tickets, B, H, page, max_pages, split_pages, scale,
                           stream);
  if (H <= 2)
    return launch<T, D, 2>(q, k_pool, v_pool, table, lengths, o, lse, part,
                           tickets, B, H, page, max_pages, split_pages, scale,
                           stream);
  if (H <= 4)
    return launch<T, D, 4>(q, k_pool, v_pool, table, lengths, o, lse, part,
                           tickets, B, H, page, max_pages, split_pages, scale,
                           stream);
  return launch<T, D, 8>(q, k_pool, v_pool, table, lengths, o, lse, part,
                         tickets, B, H, page, max_pages, split_pages, scale,
                         stream);
}

template <typename T>
int dispatch(int D, int H, const void* q, const void* k_pool,
             const void* v_pool, const void* table, const void* lengths,
             void* o, void* lse, void* part, void* tickets, int B,
             int page, int max_pages, int split_pages, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 8:
      return by_heads<T, 8>(H, q, k_pool, v_pool, table, lengths, o, lse, part,
                            tickets, B, page, max_pages, split_pages, scale,
                            stream);
    case 16:
      return by_heads<T, 16>(H, q, k_pool, v_pool, table, lengths, o, lse,
                             part, tickets, B, page, max_pages, split_pages,
                             scale, stream);
    case 32:
      return by_heads<T, 32>(H, q, k_pool, v_pool, table, lengths, o, lse,
                             part, tickets, B, page, max_pages, split_pages,
                             scale, stream);
    case 64:
      return by_heads<T, 64>(H, q, k_pool, v_pool, table, lengths, o, lse,
                             part, tickets, B, page, max_pages, split_pages,
                             scale, stream);
    case 128:
      return by_heads<T, 128>(H, q, k_pool, v_pool, table, lengths, o, lse,
                              part, tickets, B, page, max_pages, split_pages,
                              scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q, o: (B, H, D); k_pool, v_pool:
// (n_pages, page, D); table: (B, max_pages) int32 page ids; lengths: (B,)
// int32; lse: (B, H) float32, or null for none.  All contiguous; the pools
// 16-byte aligned.  A split covers split_pages (1 .. 256) table entries.
// With more than one split, part holds B * ceil(H / HG) * n_splits * HG *
// (D + 2) floats (HG: 1, 2, 4 or 8 heads a block, the least of them >=
// min(H, 8)) and tickets B * ceil(H / HG) ints, zero before the first
// launch and left zero by every launch.
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* table,
                               const void* lengths, void* o, void* lse,
                               void* part, void* tickets, int dtype, int B,
                               int H, int D, int page, int max_pages,
                               int split_pages, float scale, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (page <= 0 || max_pages <= 0 || split_pages <= 0 ||
      split_pages > kMaxSplitPages)
    return static_cast<int>(cudaErrorInvalidValue);
  if (split_pages < max_pages && (part == nullptr || tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, H, q, k_pool, v_pool, table, lengths, o, lse,
                           part, tickets, B, page, max_pages, split_pages,
                           scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, H, q, k_pool, v_pool, table, lengths, o,
                                   lse, part, tickets, B, page, max_pages,
                                   split_pages, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
