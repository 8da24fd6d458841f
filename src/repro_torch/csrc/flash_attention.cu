// flash_attention: causal or non-causal online-softmax attention,
// o[b,h] = softmax(q[b,h] k[b,h/G]^T / sqrt(D)) v[b,h/G], with the running
// max m, denominator l and accumulator kept in f32 and the output written
// in the input dtype (f32 or bf16).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (Pallas, TPU): the prefill attention of the LM serving path.  The TPU grid
// walked kv blocks as its sequential innermost axis and carried (m, l, acc)
// in VMEM scratch from one grid step to the next; here one block owns one
// (batch * head, 64-row q tile) and loops over 32-row kv tiles itself,
// staging each tile in shared memory, so the state never leaves registers.
// kv tiles wholly above the diagonal are never loaded (the causal loop ends
// at the tile's last row); the ragged edge (any S, no tile multiple needed)
// is masked in the kernel.  GQA: query head h reads KV head h / G, so the
// caller never expands K/V.  Operands are addressed through (batch, head,
// seq) strides with a contiguous D, so (B, S, H, D) views need no copy.
//
// Bound on an H100: operations at prefill lengths.  Causal work is
// 4 * B * H * D * S (S + 1) / 2 flops over 989 TFLOP/s (bf16 tensor cores),
// against q, k, v and o read or written once over 3.35 TB/s.  This first
// kernel runs scalar f32 FMAs from shared memory (4 threads per query row:
// each scores a quarter of the kv tile, then accumulates a quarter of D),
// so it reaches a fraction of that bound; mma.sync / wgmma with TMA-fed
// tiles is later work.  When the caller asks for it (lse not null), each
// row's base-2 log-sum-exp (m + ln l) log2(e) is stored beside the output,
// f32 (B, H, S), for the backward (flash_attention_bwd.cu).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 32;                 // kv rows per shared-memory tile
constexpr int kThreads = 256;
constexpr int kTPR = kThreads / kBQ;    // threads per query row
constexpr int kJ = kBK / kTPR;          // keys each thread scores per tile
constexpr float kNegInf = -1e30f;       // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;  // elements; D is contiguous
};

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int H, int group, int S,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int causal, float scale) {
  static_assert(D % kTPR == 0, "D must split over the threads of a row");
  constexpr int kDT = D / kTPR;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // kBQ x (D + 1), padded rows
  float* ks = qs + kBQ * (D + 1);    // kBK x (D + 1)
  float* vs = ks + kBK * (D + 1);    // kBK x D
  float* ps = vs + kBK * D;          // kBQ x (kBK + 1) probabilities

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / group;
  // the longest causal rows first, so the tail of the grid is short
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  const int tid = threadIdx.x;
  const int r = tid / kTPR;  // query row of this thread within the tile
  const int t = tid % kTPR;  // its quarter of the keys and of D
  const int qi = q0 + r;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int row = i / D, d = i % D;
    const int s = q0 + row;
    qs[row * (D + 1) + d] = s < S ? to_f32(qb[s * sq.s + d]) : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[kDT];
#pragma unroll
  for (int dd = 0; dd < kDT; ++dd) acc[dd] = 0.f;

  const int kend = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int row = i / D, d = i % D;
      const int s = k0 + row;
      const bool ok = s < S;
      ks[row * (D + 1) + d] = ok ? to_f32(kb[s * sk.s + d]) : 0.f;
      vs[row * D + d] = ok ? to_f32(vb[s * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float sc[kJ];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) sc[jj] = 0.f;
    const float* qrow = qs + r * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
        sc[jj] += qd * ks[(t + jj * kTPR) * (D + 1) + d];
    }
    float mt = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int kj = k0 + t + jj * kTPR;
      float x = sc[jj] * scale;
      if (kj >= S || (causal && kj > qi)) x = kNegInf;
      sc[jj] = x;
      mt = fmaxf(mt, x);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const float p = expf(sc[jj] - m_new);
      ls += p;
      ps[r * (kBK + 1) + t + jj * kTPR] = p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * corr + ls;
    m = m_new;
    __syncwarp();  // a row's probabilities come from its own quad
#pragma unroll
    for (int dd = 0; dd < kDT; ++dd) acc[dd] *= corr;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float p = ps[r * (kBK + 1) + j];
#pragma unroll
      for (int dd = 0; dd < kDT; ++dd) acc[dd] += p * vs[j * D + dd * kTPR + t];
    }
  }

  if (qi < S) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int dd = 0; dd < kDT; ++dd)
      store(ob + qi * so.s + dd * kTPR + t, acc[dd] / denom);
    if (lse != nullptr && t == 0)
      lse[static_cast<long long>(bh) * S + qi] = (m + logf(denom)) * kLog2e;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int S, Strides sq, Strides sk, Strides sv,
           Strides so, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, H / Hkv, S, sq, sk,
      sv, so, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int Hkv, int S, Strides sq, Strides sk,
             Strides sv, Strides so, int causal, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 8:
      return launch<T, 8>(q, k, v, o, lse, B, H, Hkv, S, sq, sk, sv, so,
                          causal, scale, stream);
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, H, Hkv, S, sq, sk, sv, so,
                          causal, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, Hkv, S, sq, sk, sv, so,
                          causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Hkv, S, sq, sk, sv, so,
                          causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Hkv, S, sq, sk, sv, so,
                          causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q, o: (B, H, S, D); k, v: (B, Hkv, S, D),
// each addressed through (batch, head, seq) strides in elements.  lse:
// null, or (B, H, S) f32 contiguous, written with each row's base-2
// log-sum-exp.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int H, int Hkv, int S, int D, long long sqb,
    long long sqh, long long sqs,
    long long skb, long long skh, long long sks, long long svb, long long svh,
    long long svs, long long sob, long long soh, long long sos, int causal,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs},
      so{sob, soh, sos};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, o, static_cast<float*>(lse), B, H,
                           Hkv, S, sq, sk, sv, so, causal, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, static_cast<float*>(lse),
                                   B, H, Hkv, S, sq, sk, sv, so, causal,
                                   scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
