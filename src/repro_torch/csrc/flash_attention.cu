// flash_attention: causal or non-causal online-softmax attention,
// o[b,h] = softmax(q[b,h] k[b,h/G]^T / sqrt(D)) v[b,h/G], in f32 at any
// D of {8, 16, 32, 64, 128} and in bf16 at the D the wgmma kernel does not
// take, with the running max m, denominator l (floored at 1e-30) and
// accumulator kept in f32 and the output written in the input dtype.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (Pallas, TPU): the prefill attention of the LM serving path, beside
// flash_attention_wgmma.cu, which takes bf16 at D 64 and 128.  The TPU
// grid walked kv blocks as its sequential innermost axis and carried (m,
// l, acc) in VMEM scratch; here one block owns one (batch * head, q tile)
// and loops over kv tiles itself, so the state never leaves registers.
//
// Bound on an H100: operations.  Causal work is 4 * B * H * D * S (S + 1)
// / 2 flops against q, k, v and o read or written once over 3.35 TB/s.
// f32 at full precision outside the tensor cores runs at 67 TFLOP/s, and
// f32 FMAs fed from shared memory reach a fraction of that (14 TFLOP/s
// measured at S 4,096); so both products run on the tensor cores as
// split-TF32 wgmma, each f32 product three TF32 products (tf32.cuh), and
// 495 / 3 = 165 TFLOP/s is the bound this design is held to:
//
//  * One block per (b * h, 64 kWG query rows), the longest causal rows
//    first; each of its kWG warpgroups owns 64 rows.  All threads stage
//    every tile (tf32.cuh): Q once, as hi and lo K-major tiles; each kv
//    tile's K as hi and lo, and V transposed (tf32 wgmma has no transpose
//    flag) with its keys permuted so that P's accumulator fragment is the
//    A fragment as it stands.  The next tile's loads are issued before
//    this tile's products, into registers, so global latency hides
//    behind the tensor cores; one barrier before and one after the
//    staging guard the single stage.  kv tiles wholly above the diagonal
//    are never loaded, and a warpgroup skips a tile wholly above its rows.
//  * S = Q K^T is wgmma m64nNk8 tf32 from shared memory: Q_hi K_lo +
//    Q_lo K_hi, then Q_hi K_hi.  The online softmax runs on the f32
//    accumulator fragment in base 2 (a thread holds two rows; max and sum
//    take a shuffle across the quad); keys past S or past the diagonal
//    are masked there (a zero-filled K row scores 0, not -inf).
//  * P V takes P's (hi, lo) from the fragment as register A operands:
//    P_lo V_hi + P_hi V_lo, then P_hi V_hi, in 64-column chunks of D.
//    Each tile's share is summed on the tensor cores from zero and added to
//    the rescaled accumulator in f32; l sums the unrounded f32 p.
//  * bf16 operands are exact in TF32: their lo terms are left out (one
//    product for S, two for P V).
//  * The output is stored from the fragment, masked at S.  When the
//    caller asks for it (lse not null), each row's base-2 log-sum-exp m c
//    + log2(l) (c = log2(e) / sqrt(D)) is stored beside it, f32 (B, H,
//    S), for the backward (flash_attention_bwd.cu).
//
// Tiles: 128 query rows and 64-key tiles up to D 64 (128 KB of shared
// memory, one block of eight warps an SM); at D 128, 32-key tiles (192
// KB).  Measured on an H100 at f32 D 64, S 4,096
// (scripts/tf32_variants.py): 32-key tiles 7% slower; P V summed straight
// into the rescaled accumulator on the tensor cores 6% faster but six
// times the error against a float64 reference, so each tile's share is
// added in f32.  Operands are addressed through (batch, head, seq)
// strides with D contiguous and no alignment asked, so (B, S, H, D)
// views need no copy.  GQA: query head h reads KV head h / G without
// expanding K/V.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "tf32.cuh"

namespace {

constexpr int kWG = 2;                 // consumer warpgroups a block
constexpr int kThreads = 128 * kWG;
constexpr int kBQ = 64 * kWG;          // query rows a block
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Fwd {  // byte offsets from the 1024-aligned shared base
  static constexpr int kBK = D <= 64 ? 64 : 32;  // keys a tile
  static constexpr int kDBox = (D + 31) / 32;    // box columns across D
  static constexpr int kCN = D < 64 ? D : 64;    // columns of a P V chunk
  static constexpr int kQBox = kBQ * kSwizzleRow;
  static constexpr int kKBox = kBK * kSwizzleRow;
  static constexpr int kVBox = D * kSwizzleRow;  // V^T: D rows of kBK keys
  static constexpr int kQTile = kDBox * kQBox;
  static constexpr int kKTile = kDBox * kKBox;
  static constexpr int kVTile = (kBK / 32) * kVBox;
  static constexpr int kQHi = 0, kQLo = kQTile;
  static constexpr int kKHi = 2 * kQTile, kKLo = kKHi + kKTile;
  static constexpr int kVHi = kKLo + kKTile, kVLo = kVHi + kVTile;
  static constexpr int kBytes = kVLo + kVTile;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int H, int group, int S,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int causal, float scale_log2) {
  using L = Fwd<D>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kBK = L::kBK, kCN = L::kCN, kNC = D / kCN;
  using KV = Stage<kBK, D, kThreads>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - smem_addr(smem_raw));

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / group;
  // the longest causal rows first, so the tail of the grid is short
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  const int n_tiles =
      ((causal ? min(S, q0 + kBQ) : S) + kBK - 1) / kBK;

  const int tid = threadIdx.x;
  {
    float x[Stage<kBQ, D, kThreads>::kPer];
    load_tile<kBQ, D, kThreads>(x, q + b * sq.b + h * sq.h, sq.s, q0, S, tid);
    put_tile<kSplit, kBQ, D, kThreads>(x, sm + L::kQHi, sm + L::kQLo, tid);
  }
  float kx[KV::kPer], vx[KV::kPer];
  load_tile<kBK, D, kThreads>(kx, kb, sk.s, 0, S, tid);
  load_tile<kBK, D, kThreads>(vx, vb, sv.s, 0, S, tid);

  const int wg = tid / 128;
  const int lane = tid % 32;
  const int qw0 = q0 + wg * 64;  // this warpgroup's first row
  // this thread's rows of the accumulator fragments: r0 and r0 + 8
  const int r0 = qw0 + ((tid % 128) / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);  // its first column of each 8-wide chunk
  const uint32_t qa = wg * 64 * kSwizzleRow;

  float acc[kNC][kCN / 2];
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int i = 0; i < kCN / 2; ++i) acc[c][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // every warpgroup is done with the previous tile
    put_tile<kSplit, kBK, D, kThreads>(kx, sm + L::kKHi, sm + L::kKLo, tid);
    put_tile_t<kSplit, kBK, D, kThreads>(vx, sm + L::kVHi, sm + L::kVLo, tid);
    fence_async_smem();
    __syncthreads();
    const int k0 = t * kBK;
    if (t + 1 < n_tiles) {
      load_tile<kBK, D, kThreads>(kx, kb, sk.s, k0 + kBK, S, tid);
      load_tile<kBK, D, kThreads>(vx, vb, sv.s, k0 + kBK, S, tid);
    }
    // a tile wholly above this warpgroup's rows adds nothing
    if (causal && k0 > qw0 + 63) continue;

    // scores of 64 rows x kBK keys
    float sc[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
    issue_ss<kSplit, D / 8, L::kQBox, L::kKBox>(
        sc, base + L::kQHi + qa, base + L::kQLo + qa, base + L::kKHi,
        base + L::kKLo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // register i holds row r0 + 8 * ((i / 2) % 2), key
    // k0 + 8 * (i / 4) + c0 + i % 2
    if (k0 + kBK > S || (causal && k0 + kBK - 1 > r0)) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int kj = k0 + 8 * (i / 4) + c0 + (i % 2);
        const int row = r0 + 8 * ((i / 2) % 2);
        if (kj >= S || (causal && kj > row)) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float corr[2], ms[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      // key 0 is valid for every row, so mx is finite from the first tile
      corr[j] = exp2f((m[j] - mx[j]) * scale_log2);
      m[j] = mx[j];
      ms[j] = mx[j] * scale_log2;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -ms[(i / 2) % 2]));
      rs[(i / 2) % 2] += sc[i];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = l[j] * corr[j] + rs[j];
    uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
    a_fragments<kBK / 8>(sc, ph, pl);

    // acc = acc corr + P V, a chunk of kCN columns of D at a time
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      float part[kCN / 2];
#pragma unroll
      for (int i = 0; i < kCN / 2; ++i) part[i] = 0.f;
      const uint32_t rows = c * kCN * kSwizzleRow;
      wgmma_fence();
      issue_rs<kSplit, kBK / 8, L::kVBox>(part, ph, pl, base + L::kVHi + rows,
                                          base + L::kVLo + rows);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < kCN / 2; ++i)
        acc[c][i] = fmaf(acc[c][i], corr[(i / 2) % 2], part[i]);
    }
  }

  // each quad lane summed its own columns of the two rows
  float denom[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    denom[j] = fmaxf(l[j], 1e-30f);
  }
  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = r0 + 8 * j;
    if (row >= S) continue;
    if (lse != nullptr && lane % 4 == 0)
      lse[static_cast<long long>(bh) * S + row] =
          m[j] * scale_log2 + log2f(denom[j]);
    T* orow = ob + row * so.s;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int n8 = 0; n8 < kCN / 8; ++n8) {
        const int i = 4 * n8 + 2 * j;
        const int col = c * kCN + 8 * n8 + c0;
        store(orow + col, acc[c][i] / denom[j]);
        store(orow + col + 1, acc[c][i + 1] / denom[j]);
      }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int S, Strides sq, Strides sk, Strides sv,
           Strides so, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = Fwd<D>::kBytes + 1024;  // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, H / Hkv, S, sq, sk,
      sv, so, causal, scale * kLog2e);
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
