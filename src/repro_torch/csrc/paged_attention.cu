// paged_attention: one-token decode attention through a block table,
// o[b, h] = softmax(q[b, h] K_b^T / sqrt(D)) V_b, where K_b and V_b are the
// first lengths[b] rows of the pages block_table[b, :] of a shared
// (n_pages, page, D) pool with no head axis (every head of row b reads the
// same K/V).  m, l and the accumulator are f32; the output is written in
// the input dtype (f32 or bf16).
//
// Replaces src/repro/kernels/paged_attention/kernel.py::paged_attention_kernel
// (Pallas, TPU): the decode attention of the LM serving path.  On the TPU the
// table and lengths rode in scalar prefetch and the grid walked
// (row, page) in order with the online-softmax state in VMEM scratch.  Here
// one block owns one (row, group of up to 8 heads) and loads its own table
// row and length from device memory.  Its 8 warps split the row's tokens:
// the lanes of a warp form groups of D * sizeof(T) / 16 lanes, each group
// reads one token's K and V row with 16-byte loads along D, reduces the
// q.k dot across the group with shuffles, and keeps its own online-softmax
// state; the block combines the groups' states through shared memory at the
// end.  Only tokens below the length are read: pages wholly past it are
// never touched.
//
// Bound on an H100: bytes.  Each step reads the K and V rows below the
// lengths once (2 * sum(lengths) * D * sizeof(T)) and does 4 * D flops per
// row, head and token, far under the 295 flops a byte the tensor cores need;
// the least time is those bytes over 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the reference's initial running max

template <typename T>
struct Vec;  // one 16-byte load of T, widened to f32

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
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

template <typename T, int D, int HG>
struct Shape {
  static constexpr int kVec = Vec<T>::kN;      // elements per 16-byte load
  static constexpr int kLanes = D / kVec;      // lanes reading one token
  static constexpr int kTokens = 32 / kLanes;  // tokens per warp pass
  static constexpr int kParts = kWarps * kTokens;
  static constexpr int kSmem = kParts * HG * (D + 2) * 4;
  static_assert(D % kVec == 0 && kLanes <= 32 && 32 % kLanes == 0,
                "D * sizeof(T) must be 16, 32, ..., 512 bytes");
};

template <typename T, int D, int HG>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ table,
                       const int* __restrict__ lengths, T* __restrict__ o,
                       int H, int page, int max_pages, float scale) {
  using S = Shape<T, D, HG>;
  constexpr int kVec = S::kVec;
  constexpr int kLanes = S::kLanes;
  constexpr int kTokens = S::kTokens;
  extern __shared__ float smem[];
  float* sm_m = smem;                        // kParts x HG
  float* sm_l = sm_m + S::kParts * HG;       // kParts x HG
  float* sm_acc = sm_l + S::kParts * HG;     // kParts x HG x D

  const int row = blockIdx.x;
  const int h0 = blockIdx.y * HG;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / kLanes;  // token slot of this lane's group
  const int c = lane % kLanes;  // its chunk of D
  const int len = min(lengths[row], max_pages * page);
  const int* trow = table + static_cast<long long>(row) * max_pages;

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

  // a warp-uniform loop: every lane reaches the shuffles
  for (int base = warp * kTokens; base < len; base += kWarps * kTokens) {
    const int t = base + g;
    const bool ok = t < len;
    float kf[kVec], vf[kVec];
    if (ok) {
      const long long off =
          (static_cast<long long>(trow[t / page]) * page + t % page) * D +
          c * kVec;
      Vec<T>::load(k_pool + off, kf);
      Vec<T>::load(v_pool + off, vf);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) s += qv[h][e] * kf[e];
#pragma unroll
      for (int w = kLanes / 2; w > 0; w >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, w);
      if (ok) {
        s *= scale;
        const float m_new = fmaxf(m[h], s);
        const float corr = expf(m[h] - m_new);
        const float p = expf(s - m_new);
        l[h] = l[h] * corr + p;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[h][e] = acc[h][e] * corr + p * vf[e];
        m[h] = m_new;
      }
    }
  }

  const int part = warp * kTokens + g;
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    if (c == 0) {
      sm_m[part * HG + h] = m[h];
      sm_l[part * HG + h] = l[h];
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      sm_acc[(part * HG + h) * D + c * kVec + e] = acc[h][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HG * D; i += kThreads) {
    const int h = i / D, d = i % D;
    if (h0 + h >= H) continue;
    float mx = kNegInf;
    for (int p = 0; p < S::kParts; ++p) mx = fmaxf(mx, sm_m[p * HG + h]);
    float num = 0.f, den = 0.f;
    for (int p = 0; p < S::kParts; ++p) {
      const float w = expf(sm_m[p * HG + h] - mx);
      den += sm_l[p * HG + h] * w;
      num += sm_acc[(p * HG + h) * D + d] * w;
    }
    store(o + (static_cast<long long>(row) * H + h0 + h) * D + d,
          num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D, int HG>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* lengths, void* o, int B, int H,
           int page, int max_pages, float scale, cudaStream_t stream) {
  constexpr int smem = Shape<T, D, HG>::kSmem;  // up to 80 KiB: opt in
  const cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T, D, HG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B),
                  static_cast<unsigned>((H + HG - 1) / HG));
  paged_attention_kernel<T, D, HG><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(o), H, page,
      max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_heads(const void* q, const void* k_pool, const void* v_pool,
             const void* table, const void* lengths, void* o, int B, int H,
             int page, int max_pages, float scale, cudaStream_t stream) {
  if (H <= 1)
    return launch<T, D, 1>(q, k_pool, v_pool, table, lengths, o, B, H, page,
                           max_pages, scale, stream);
  if (H <= 2)
    return launch<T, D, 2>(q, k_pool, v_pool, table, lengths, o, B, H, page,
                           max_pages, scale, stream);
  if (H <= 4)
    return launch<T, D, 4>(q, k_pool, v_pool, table, lengths, o, B, H, page,
                           max_pages, scale, stream);
  return launch<T, D, 8>(q, k_pool, v_pool, table, lengths, o, B, H, page,
                         max_pages, scale, stream);
}

template <typename T>
int dispatch(int D, const void* q, const void* k_pool, const void* v_pool,
             const void* table, const void* lengths, void* o, int B, int H,
             int page, int max_pages, float scale, cudaStream_t stream) {
  switch (D) {
    case 8:
      return by_heads<T, 8>(q, k_pool, v_pool, table, lengths, o, B, H, page,
                            max_pages, scale, stream);
    case 16:
      return by_heads<T, 16>(q, k_pool, v_pool, table, lengths, o, B, H,
                             page, max_pages, scale, stream);
    case 32:
      return by_heads<T, 32>(q, k_pool, v_pool, table, lengths, o, B, H,
                             page, max_pages, scale, stream);
    case 64:
      return by_heads<T, 64>(q, k_pool, v_pool, table, lengths, o, B, H,
                             page, max_pages, scale, stream);
    case 128:
      return by_heads<T, 128>(q, k_pool, v_pool, table, lengths, o, B, H,
                              page, max_pages, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q, o: (B, H, D); k_pool, v_pool:
// (n_pages, page, D); table: (B, max_pages) int32 page ids; lengths: (B,)
// int32.  All contiguous; the pools 16-byte aligned.
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* table,
                               const void* lengths, void* o, int dtype, int B,
                               int H, int D, int page, int max_pages,
                               float scale, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (page <= 0 || max_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k_pool, v_pool, table, lengths, o, B, H,
                           page, max_pages, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k_pool, v_pool, table, lengths, o, B,
                                   H, page, max_pages, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
