// flash_attention_wgmma: causal or non-causal online-softmax attention in
// bf16 at D in {64, 128} on Hopper's tensor cores,
// o[b,h] = softmax(q[b,h] k[b,h/G]^T / sqrt(D)) v[b,h/G], with the running
// max m, denominator l (floored at 1e-30) and accumulator kept in f32 and
// the output written in bf16.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (Pallas, TPU), beside the split-TF32 kernel of flash_attention.cu, which
// keeps f32 and the small head dims.  The wrapper (kernels/flash_attention/
// kernel.py) sends bf16 at D 64 and 128 here and nothing else.
//
// Bound on an H100: operations.  Causal work is 4 * B * H * D * S (S + 1) / 2
// flops over 989 TFLOP/s (bf16 dense), against q, k, v and o read or written
// once over 3.35 TB/s: at S 1,024 and D 64 the tensor work is about 20 times
// the memory time.  So the design feeds the tensor cores and keeps every
// intermediate on the SM:
//
//  * One block per (b * h, 128-row q tile), the longest causal rows first.
//    Warpgroups 0 and 1 each own 64 query rows; warpgroup 2 is the
//    producer, and one of its threads issues every copy.  setmaxnreg moves
//    registers from the producer (24) to the consumers (240).
//  * TMA copies 128-row tiles through 4-d tensor maps (D, S, heads, B)
//    built on the host from the operands' strides, so (B, S, H, D) views
//    are read in place.  Boxes are 64 bf16 wide with the 128-byte swizzle
//    (D 128 is two boxes), the same swizzle the wgmma descriptors name.
//    Rows past S arrive as zeros.  Q is copied once; K and V tiles go
//    through a 2-stage ring of shared memory guarded by mbarrier full/empty
//    pairs.  kv tiles wholly above the diagonal are never loaded.
//  * S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//    (K-major).  The online softmax runs on the f32 accumulator fragment:
//    a thread holds two rows, whose max and sum take a shuffle across the
//    quad that shares them, and keys past S or past the diagonal are masked
//    in the fragment (a zero-filled K row scores 0, not -inf).
//  * P V keeps P's low half: P is split into bf16 hi = bf16(p) and
//    lo = bf16(p - hi), each laid out as a register A fragment (the f32 C
//    fragment of a k16 chunk is the A fragment's layout), and both go
//    through wgmma m64n64k16 (V from shared memory, MN-major, transposed)
//    into one f32 accumulator; l sums the unrounded f32 p.  A P rounded
//    once to bf16 errs by 2^-9 of sum |p v| / l, which near-zero outputs
//    cannot absorb; the split costs half again the tensor work of P V.
//  * The output is stored from the fragment, 4 bytes a thread, masked at S.
//    When the caller asks for it (lse not null), each row's base-2
//    log-sum-exp m c + log2(l) (c = log2(e) / sqrt(D)) is stored beside
//    it, f32 (B, H, S): the backward (flash_attention_bwd.cu) recomputes
//    P from it.
//
// The mbarrier, TMA, descriptor, wgmma and tensor-map helpers are
// hopper.cuh's, shared with the backward.
//
// Later work: the G query heads of one KV head are separate blocks (L2
// serves the re-reads of K and V); softmax and wgmma of one warpgroup do
// not overlap.
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 128;              // query rows per block
constexpr int kBK = 128;              // kv rows per tile
constexpr int kStages = 2;            // K/V ring depth
constexpr int kThreads = 384;         // 2 consumer warpgroups + 1 producer
constexpr int kBoxBytes = kBK * kBox * 2;   // one 128-row box: 16,384 B
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {  // byte offsets from the 1024-aligned shared base
  static constexpr int kSub = D / kBox;           // boxes across D
  static constexpr int kTile = kSub * kBoxBytes;  // one Q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBytes = kV + kStages * kTile;
};

// -------------------------------------------------------------------- kernel
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse, Strides so, int H,
                             int group, int S, int causal, float scale_log2) {
  using L = Layout<D>;
  constexpr int kSub = L::kSub;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qfull;
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / group;
  // the longest causal rows first, so the tail of the grid is short
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kBQ;
  const int n_tiles = causal ? qt + 1 : (S + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), 2 * 128);
    }
    mbar_init(smem_addr(&qfull), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      const uint32_t qbar = smem_addr(&qfull);
      mbar_expect_tx(qbar, L::kTile);
      for (int sub = 0; sub < kSub; ++sub)
        tma_load(base + L::kQ + sub * kBoxBytes, &tq, qbar, sub * kBox, q0, h,
                 b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)
          mbar_wait(smem_addr(&empty[s]), ((t / kStages) - 1) & 1);
        const uint32_t bar = smem_addr(&full[s]);
        mbar_expect_tx(bar, 2 * L::kTile);
        for (int sub = 0; sub < kSub; ++sub) {
          tma_load(base + L::kK + s * L::kTile + sub * kBoxBytes, &tk, bar,
                   sub * kBox, t * kBK, hk, b);
          tma_load(base + L::kV + s * L::kTile + sub * kBoxBytes, &tv, bar,
                   sub * kBox, t * kBK, hk, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    // this thread's rows of the accumulator fragments: r0 and r0 + 8
    const int r0 = q0 + wg * 64 + (tid / 32) * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);  // its first column of each 8-wide chunk
    const uint32_t qa = base + L::kQ + wg * 64 * 128;

    float acc[kSub][32];
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[sub][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};

    mbar_wait(smem_addr(&qfull), 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(smem_addr(&full[s]), (t / kStages) & 1);
      const uint32_t ka = base + L::kK + s * L::kTile;
      const uint32_t va = base + L::kV + s * L::kTile;

      // scores of 64 rows x 128 keys
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t off = (kc / 4) * kBoxBytes + (kc % 4) * 32;
        wgmma_ss(sc, sw128_desc(qa + off), sw128_desc(ka + off), kc > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // register i holds row r0 + 8 * ((i / 2) % 2), key
      // k0 + 8 * (i / 4) + c0 + i % 2
      const int k0 = t * kBK;
      if (k0 + kBK > S || (causal && k0 + kBK - 1 > r0)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int kj = k0 + 8 * (i / 4) + c0 + (i % 2);
          const int row = r0 + 8 * ((i / 2) % 2);
          if (kj >= S || (causal && kj > row)) sc[i] = -INFINITY;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i)
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

      // p in f32, split into bf16 hi and lo A fragments: chunk kc covers
      // keys 16 kc .. 16 kc + 15; its register q packs sc[8 kc + 2 q] and
      // sc[8 kc + 2 q + 1] (row r0 for even q, r0 + 8 for odd q)
      uint32_t phi[8][4], plo[8][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 8 * kc + 2 * q;
          const float p0 = exp2f(fmaf(sc[i], scale_log2, -ms[q % 2]));
          const float p1 = exp2f(fmaf(sc[i + 1], scale_log2, -ms[q % 2]));
          rs[q % 2] += p0 + p1;
          split(p0, p1, phi[kc][q], plo[kc][q]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) l[j] = l[j] * corr[j] + rs[j];
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[sub][i] *= corr[(i / 2) % 2];

      // acc += p_hi v + p_lo v
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
#pragma unroll
        for (int sub = 0; sub < kSub; ++sub) {
          const uint64_t vd =
              sw128_desc(va + sub * kBoxBytes + kc * 16 * 128);
          wgmma_rs(acc[sub], phi[kc], vd, 1);
          wgmma_rs(acc[sub], plo[kc], vd, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) fence_regs(acc[sub]);
      mbar_arrive(smem_addr(&empty[s]));
    }

    // each quad lane summed its own columns of the two rows
    float denom[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
      denom[j] = fmaxf(l[j], 1e-30f);
    }
    __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = r0 + 8 * j;
      if (row >= S) continue;
      if (lse != nullptr && lane % 4 == 0)
        lse[(static_cast<long long>(b) * H + h) * S + row] =
            m[j] * scale_log2 + log2f(denom[j]);
      __nv_bfloat16* orow = ob + row * so.s;
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int i = 4 * n8 + 2 * j;
          *reinterpret_cast<__nv_bfloat162*>(orow + sub * kBox + 8 * n8 + c0) =
              __floats2bfloat162_rn(acc[sub][i] / denom[j],
                                    acc[sub][i + 1] / denom[j]);
        }
    }
  }
}

// ------------------------------------------------------------------- host
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int S, Strides sq, Strides sk, Strides sv,
           Strides so, int causal, float scale, cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, B, H, S, D, sq, kBQ) ||
      !encode(fn, &tk, k, B, Hkv, S, D, sk, kBK) ||
      !encode(fn, &tv, v, B, Hkv, S, D, sv, kBK))
    return static_cast<int>(cudaErrorInvalidPitchValue);
  constexpr int smem = Layout<D>::kBytes + 1024;  // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_attention_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, so, H, H / Hkv, S,
      causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 only.  q, o: (B, H, S, D); k, v: (B, Hkv, S, D), each addressed
// through (batch, head, seq) strides in elements with D contiguous; q, k
// and v need 16-byte aligned bases and strides (of the dims longer than 1)
// that are multiples of 8 elements.  D is 64 or 128.  lse: null, or (B, H,
// S) f32 contiguous, written with each row's base-2 log-sum-exp.
extern "C" int flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Hkv, int S, int D, long long sqb, long long sqh, long long sqs,
    long long skb, long long skh, long long sks, long long svb, long long svh,
    long long svs, long long sob, long long soh, long long sos, int causal,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs},
      so{sob, soh, sos};
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, static_cast<float*>(lse), B, H, Hkv, S, sq,
                      sk, sv, so, causal, scale, st);
  if (D == 128)
    return launch<128>(q, k, v, o, static_cast<float*>(lse), B, H, Hkv, S, sq,
                       sk, sv, so, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
