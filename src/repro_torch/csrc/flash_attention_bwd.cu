// flash_attention_backward(_wgmma): the gradient of flash attention,
// (dq, dk, dv) of o[b,h] = softmax(q[b,h] k[b,h/G]^T / sqrt(D)) v[b,h/G],
// causal or not, from the saved q, k, v, output o, the forward's base-2
// log-sum-exp lse and the output's gradient dO.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (Pallas, TPU) under autograd: this is that kernel's gradient, which the
// reference takes with jax.grad of its jnp attention (it has no backward
// kernel).  The port launches its forward kernels under an
// autograd.Function, and this file is that Function's backward on the card
// (kernels/flash_attention/kernel.py::run_backward); the plain PyTorch
// backward stays for CPU tensors.
//
// Bound on an H100: operations.  Five products of 2 D flops a (query,
// key) pair and head -- S = q k^T and dP = dO v^T recomputed, dV += P^T dO,
// dK += dS^T q, dQ += dS k -- so 10 B H D S (S + 1) / 2 flops over 989
// TFLOP/s at causal prefill lengths, against q, k, v, o, dO read and dq,
// dk, dv written once over 3.35 TB/s (at granite's training shape the
// tensor work is 0.35 ms, the bytes 0.025 ms).
//
// The kernel runs ten products where the bound counts five: S and dP are
// recomputed in both (b) and (c) below, and P and dS go through their
// three products as bf16 hi + lo pairs (hi = bf16(x), lo = bf16(x - hi)),
// as the forward's P V does.  Rounded once to bf16 they err by 2^-9 of
// the sum of |terms|, which gradients near zero cannot absorb (the CPU
// emulation in tests/test_torch_flash_backward.py fails the card's check
// that way).  Each streamed tile's share of dK, dV or dQ is summed on the
// tensor cores from zero (scale-d 0 on its first k16 step) and added to
// the running sum in f32: summed straight on the tensor cores over a
// whole row of 4,096, the running sums lost low bits past the check.
//
// Each entry point launches three kernels on the caller's stream; each of
// dq, dk and dv is written once, in the operands' dtype, in a fixed order
// of sums: no float atomics, so two calls on the same inputs give the same
// bits (a one-rank mesh step is held bit for bit to the unsharded one).
//
// The bf16 route (D 64 and 128; flash_attention_backward_wgmma), built on
// hopper.cuh as the forward is:
//  (a) a row pass, delta_i = sum_d dO_id o_id in f32 from the saved
//      output (the plain version takes delta from it too, so the card's
//      check compares like with like): 8 lanes a row, 16-byte loads, the
//      lanes' sums met by shuffles.  It writes delta and a copy of lse in
//      rows padded to a multiple of 128 (0 and +inf past S, so padded
//      queries give P = 0 with no mask), which (b) and (c) copy in bulk.
//  (b) dK/dV: one block per (b, KV head, 128-key tile), the longest causal
//      tiles first.  Warpgroups 0 and 1 each own 64 keys; a ninth warp is
//      the producer, one of its threads issuing every copy up to kStages
//      tiles ahead.  K and V are copied once; the Q and dO tiles of the
//      group's G query heads (64 rows at D 64, 32 at D 128) stream through
//      a 4-stage ring of shared memory guarded by mbarrier full/empty
//      pairs, with their lse and delta rows beside them.  Query tiles
//      wholly above the diagonal are never loaded, and a warpgroup skips a
//      tile wholly above its own keys.  TMA reads every tile through 4-d
//      tensor maps built from the operands' strides, so (B, S, H, D) views
//      are read in place, with the 128-byte swizzle the descriptors name.
//      S^T = K Q^T and dP^T = V dO^T are wgmma with both operands in
//      shared memory (K-major), in two commit groups so that P^T =
//      exp2(S^T c - lse) is formed while dP^T runs; dS^T = P^T o (dP^T -
//      delta) follows in the f32 accumulator fragments, whose layout is
//      the register A fragment's; dV += P^T dO and dK += dS^T Q are wgmma
//      with A from registers (hi, lo) and B read MN-major from the same
//      swizzled Q and dO tiles.  The GQA sum over the group stays in
//      registers.  Nine warps leave 168 registers a thread (three warps
//      share a quarter of the SM's registers).
//  (c) dQ: one block per (b, head, 128-query tile), the same shape with Q
//      and dO copied once and 64-key tiles of K and V streamed up to the
//      diagonal: S = Q K^T and dP = dO V^T from shared memory, dQ += dS K
//      with dS as (hi, lo) register fragments and K read MN-major.  Its
//      eight warps have no producer warp: thread 0 also refills the ring,
//      kLag tiles behind.  Each kernel's producer is the one that measured
//      faster for it on an H100 (PERF.md §6).
// P is exp2 on the special-function unit (ex2.approx.ftz), its
// subnormal results flushed to zero.
//
// The split-TF32 route (f32 at any D, bf16 at D 8 to 32;
// flash_attention_backward).  Its bound is the same count of operations
// over 165 TFLOP/s: each f32 product is three TF32 products at 495
// TFLOP/s (tf32.cuh); f32 FMAs fed from shared memory reached 7 TFLOP/s
// at f32 D 64.  Its five products are split-TF32 wgmma: Q_hi K_lo + Q_lo
// K_hi + Q_hi K_hi for S, and so on, the small terms first, with P and dS
// split from their f32 fragments as register A operands (bf16 operands
// are exact in TF32 and take only their hi terms).
//  (a) the row pass: one thread a row, delta in f32 from the saved output.
//  (b) dK/dV: one block per (b, query head, 64-key tile), one warpgroup;
//      K and V staged once as hi and lo tiles; the head's query tiles of
//      16 rows streamed, each staged as it is (the B of S^T = K Q^T and
//      dP^T = V dO^T) and transposed (the B of dV += P^T dO and dK += dS^T
//      Q: tf32 wgmma reads shared memory K-major only), its next tile
//      loaded into registers while this one's products run.  Up to D 64
//      that is 96 KB of shared memory, two blocks an SM (32-row tiles, one
//      block an SM, measured 7% slower at f32 D 64).
//      Under GQA each head's share goes to f32 scratch, and a fourth
//      kernel sums a group's shares in head order: a block per KV head
//      leaves the longest causal block G heads' tiles and the grid G
//      times fewer blocks (128 at f32 D 64, S 1,024: measured 1.4× slower,
//      scripts/tf32_variants.py).
//  (c) dQ: one block per (b, head, 64-query tile), the same shape; K and V
//      tiles streamed up to the diagonal, K also transposed for dQ += dS K.
// Each streamed tile's share of dK, dV or dQ is summed on the tensor cores
// from zero and added in f32, as on the bf16 route, and the group's sum
// runs in head order: a fixed order of sums here too.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct AllStrides {
  Strides q, k, v, dout, dq, dk, dv;
};

// ------------------------------------------------------- (a) f32 row pass
// One thread a (b, h, s) row; delta is (B, H, S) contiguous.
template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int H, int S, int D, long long rows,
             Strides so, Strides sdo) {
  const long long row = blockIdx.x * 256LL + threadIdx.x;
  if (row >= rows) return;
  const long long bh = row / S;
  const int s = static_cast<int>(row % S);
  const int h = static_cast<int>(bh % H);
  const long long b = bh / H;
  const T* orow = o + b * so.b + h * so.h + s * so.s;
  const T* drow = dout + b * sdo.b + h * sdo.h + s * sdo.s;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(to_f32(drow[d]), to_f32(orow[d]), acc);
  delta[row] = acc;
}

// ------------------------------------------------------ bf16: wgmma route
constexpr int kOwn = 128;        // rows a block owns: keys in (b), queries in (c)
constexpr int kHalf = 64;        // rows a consumer warpgroup owns
constexpr int kStages = 4;       // ring depth of the streamed tiles
constexpr int kConsumers = 256;  // 2 consumer warpgroups
constexpr int kLag = 2;          // (c): tiles between a stage's release and
                                 // its refill by thread 0
constexpr int kRowLanes = 8;     // row pass: lanes a row

// The row length of the row pass's lse and delta copies: S rounded up to
// the owned tiles, so every streamed tile's rows lie inside.
__host__ __device__ constexpr int padded(int S) {
  return (S + kOwn - 1) / kOwn * kOwn;
}

// Rows of a streamed tile: queries in (b), 64 at D 64 and 32 at D 128
// (dK and dV take all of a thread's registers at D 128); keys in (c).
template <int D>
constexpr int kQueryTile = D == 64 ? 64 : 32;
constexpr int kKeyTile = 64;

template <int D, int N>
struct Wg {  // byte offsets from the 1024-aligned shared base
  static constexpr int kSub = D / kBox;              // boxes across D
  static constexpr int kN = N;                       // rows of a streamed tile
  static constexpr int kOwnSub = kOwn * kSwizzleRow;  // a box column, owned
  static constexpr int kOwnTile = kSub * kOwnSub;
  static constexpr int kBoxBytes = kN * kSwizzleRow;  // a box column, streamed
  static constexpr int kTile = kSub * kBoxBytes;
  static constexpr int kA = 0;             // K in (b), Q in (c)
  static constexpr int kB = kOwnTile;      // V in (b), dO in (c)
  static constexpr int kRing = 2 * kOwnTile;  // a stage: Q, dO or K, V
  static constexpr int kStage = 2 * kTile;
  static constexpr int kLse = kRing + kStages * kStage;  // a stage: lse, delta
  static constexpr int kLseStage = 2 * kN * 4;
  static constexpr int kBytes = kLse + kStages * kLseStage;
};

// (a) bf16 row pass: kRowLanes lanes a row of the padded (B, H, Sp)
// layout, each reading D / kRowLanes values of o and dO in 16-byte loads.
// Writes delta and lse's copy there: rows past S get 0 and +inf.
template <int D>
__global__ void __launch_bounds__(256)
row_pass_kernel(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse_pad,
                float* __restrict__ delta_pad, int H, int S, int Sp,
                long long rows, Strides so, Strides sdo) {
  constexpr int kLoads = D / (8 * kRowLanes);  // 16-byte loads a lane
  const long long row = (blockIdx.x * 256LL + threadIdx.x) / kRowLanes;
  const int part = threadIdx.x % kRowLanes;
  const long long bh = row / Sp;
  const int s = static_cast<int>(row % Sp);
  const bool live = row < rows && s < S;
  float acc = 0.f;
  if (live) {
    const long long b = bh / H;
    const int h = static_cast<int>(bh % H);
    const uint4* orow = reinterpret_cast<const uint4*>(
        o + b * so.b + h * so.h + s * so.s);
    const uint4* drow = reinterpret_cast<const uint4*>(
        dout + b * sdo.b + h * sdo.h + s * sdo.s);
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      uint4 x = __ldg(orow + part + j * kRowLanes);
      uint4 y = __ldg(drow + part + j * kRowLanes);
      const __nv_bfloat162* xo = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yd = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(xo[e]);
        const float2 g = __bfloat1622float2(yd[e]);
        acc = fmaf(g.x, a.x, acc);
        acc = fmaf(g.y, a.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (part == 0 && row < rows) {
    delta_pad[row] = acc;
    lse_pad[row] = live ? lse[bh * S + s] : INFINITY;
  }
}

// 2^x on the special-function unit, subnormal results flushed to zero: a
// P below 2^-126 adds nothing a bf16 gradient keeps.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The (hi, lo) register A fragments of the k16 chunks of an f32
// accumulator x (64 rows x 16 kChunks columns): chunk kc's register q
// packs x[8 kc + 2 q] and x[8 kc + 2 q + 1].
template <int kChunks>
__device__ __forceinline__ void split_fragments(const float (&x)[8 * kChunks],
                                                uint32_t (&hi)[kChunks][4],
                                                uint32_t (&lo)[kChunks][4]) {
#pragma unroll
  for (int kc = 0; kc < kChunks; ++kc)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split(x[8 * kc + 2 * q], x[8 * kc + 2 * q + 1], hi[kc][q], lo[kc][q]);
}

// acc[sub] += a b over one streamed tile: a the (hi, lo) fragments of its
// kChunks k16 chunks, b box column `sub` of the tile at `tile` (16 kChunks
// rows, box columns kBoxBytes apart) read MN-major.  Each box column's
// share is summed from zero on the tensor cores, then added in f32 (the
// promotion).
template <int kSub, int kChunks, int kBoxBytes>
__device__ __forceinline__ void add_share(float (&acc)[kSub][32],
                                          const uint32_t (&hi)[kChunks][4],
                                          const uint32_t (&lo)[kChunks][4],
                                          uint32_t tile) {
#pragma unroll
  for (int sub = 0; sub < kSub; ++sub) {
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kChunks; ++kc) {
      const uint64_t bd =
          sw128_desc(tile + sub * kBoxBytes + kc * 16 * kSwizzleRow);
      wgmma_rs(part, hi[kc], bd, kc > 0);
      wgmma_rs(part, lo[kc], bd, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[sub][i] += part[i];
  }
}

// Issue S (or S^T) and dP (or dP^T) of one warpgroup's 64 owned rows
// against a streamed tile, sc = a b^T and dp = da db^T over D, all four
// K-major in shared memory (a, da owned, box columns kOwnSub apart; b, db
// streamed, kBoxBytes apart), as two commit groups: after wgmma_wait<1>
// sc is ready while dp runs on, after wgmma_wait<0> both.
template <int D, int kN, int kOwnSub, int kBoxBytes>
__device__ __forceinline__ void issue_scores(float (&sc)[kN / 2],
                                             float (&dp)[kN / 2], uint32_t a,
                                             uint32_t b, uint32_t da,
                                             uint32_t db) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) sc[i] = dp[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    wgmma_ss(sc, sw128_desc(a + (kc / 4) * kOwnSub + (kc % 4) * 32),
             sw128_desc(b + (kc / 4) * kBoxBytes + (kc % 4) * 32), kc > 0);
  wgmma_commit();
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    wgmma_ss(dp, sw128_desc(da + (kc / 4) * kOwnSub + (kc % 4) * 32),
             sw128_desc(db + (kc / 4) * kBoxBytes + (kc % 4) * 32), kc > 0);
  wgmma_commit();
}

// Store a warpgroup's 64 x D f32 accumulator, times `mul`, as bf16 rows
// row0 and row0 + 8 of this thread (those below S), columns c0, c0 + 1 of
// each 8-wide chunk.
template <int kSub>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long rs,
                                           const float (&acc)[kSub][32],
                                           int row0, int S, float mul,
                                           int c0) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + 8 * j;
    if (row >= S) continue;
    __nv_bfloat16* out = base + row * rs;
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int i = 4 * n8 + 2 * j;
        *reinterpret_cast<__nv_bfloat162*>(out + sub * kBox + 8 * n8 + c0) =
            __floats2bfloat162_rn(acc[sub][i] * mul, acc[sub][i + 1] * mul);
      }
  }
}

struct Maps {
  CUtensorMap q, k, v, dout;  // boxes of 64 x kN
};

struct WgArgs {
  const float *lse, *delta;  // (B, H, Sp), from the row pass
  __nv_bfloat16 *dq, *dk, *dv;
  Strides sdq, sdk, sdv;
  int H, Hkv, S, causal;
  float c, scale;  // c = log2(e) / sqrt(D), scale = 1 / sqrt(D)
};

__device__ __forceinline__ void init_ring(uint64_t (&full)[kStages],
                                          uint64_t (&empty)[kStages],
                                          uint64_t& own) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), kConsumers);
    }
    mbar_init(smem_addr(&own), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// (b) dK and dV of one (b, KV head, 128-key tile).  Warp 8 is the
// producer: one of its threads issues every copy, up to kStages tiles
// ahead of the consumers.
template <int D>
__global__ void __launch_bounds__(kConsumers + 32, 1)
dkdv_wgmma_kernel(const __grid_constant__ Maps maps, WgArgs p) {
  using L = Wg<D, kQueryTile<D>>;
  constexpr int kSub = L::kSub, kN = L::kN;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], own;
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint8_t* sm = smem_raw + (base - smem_addr(smem_raw));

  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
  const int group = p.H / p.Hkv;
  const int k0 = blockIdx.y * kOwn;  // causal: the longest tiles first
  const int qt0 = p.causal ? k0 / kN : 0;
  const int nq = (p.S + kN - 1) / kN - qt0;  // query tiles a head
  const int n_iter = group * nq;
  init_ring(full, empty, own);

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == kConsumers) {
      const uint32_t obar = smem_addr(&own);
      mbar_expect_tx(obar, 2 * L::kOwnTile);
      for (int sub = 0; sub < kSub; ++sub)
        for (int j = 0; j < kOwn / kN; ++j) {
          const uint32_t off = sub * L::kOwnSub + j * L::kBoxBytes;
          tma_load(base + L::kA + off, &maps.k, obar, sub * kBox,
                   k0 + j * kN, hk, b);
          tma_load(base + L::kB + off, &maps.v, obar, sub * kBox,
                   k0 + j * kN, hk, b);
        }
      const int Sp = padded(p.S);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          mbar_wait(smem_addr(&empty[s]), ((it / kStages) - 1) & 1);
        const int h = hk * group + it / nq;
        const int q0 = (qt0 + it % nq) * kN;
        const uint32_t bar = smem_addr(&full[s]);
        const uint32_t st = base + L::kRing + s * L::kStage;
        mbar_expect_tx(bar, L::kStage + L::kLseStage);
        for (int sub = 0; sub < kSub; ++sub) {
          tma_load(st + sub * L::kBoxBytes, &maps.q, bar, sub * kBox, q0, h,
                   b);
          tma_load(st + L::kTile + sub * L::kBoxBytes, &maps.dout, bar,
                   sub * kBox, q0, h, b);
        }
        const long long row = (static_cast<long long>(b) * p.H + h) * Sp + q0;
        const uint32_t ls = base + L::kLse + s * L::kLseStage;
        bulk_load(ls, p.lse + row, kN * 4, bar);
        bulk_load(ls + kN * 4, p.delta + row, kN * 4, bar);
      }
    }
    return;
  }
  // ------------------------------------------------------------- consumers
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int kw0 = k0 + wg * kHalf;  // this warpgroup's first key
  // this thread's keys (fragment rows): key0 and key0 + 8
  const int key0 = kw0 + (tid / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);  // its first column of each 8-wide chunk
  const uint32_t ka = base + L::kA + wg * kHalf * kSwizzleRow;
  const uint32_t va = base + L::kB + wg * kHalf * kSwizzleRow;

  float dk[kSub][32], dv[kSub][32];
#pragma unroll
  for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[sub][i] = dv[sub][i] = 0.f;

  mbar_wait(smem_addr(&own), 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    mbar_wait(smem_addr(&full[s]), (it / kStages) & 1);
    const int q0 = (qt0 + it % nq) * kN;
    // a tile wholly above this warpgroup's keys adds nothing
    if (!p.causal || q0 + kN > kw0) {
      const uint32_t qa = base + L::kRing + s * L::kStage;
      const uint32_t da = qa + L::kTile;
      const float* lrow =
          reinterpret_cast<const float*>(sm + L::kLse + s * L::kLseStage);
      const float* drow = lrow + kN;
      float st[kN / 2], dpt[kN / 2];
      issue_scores<D, kN, L::kOwnSub, L::kBoxBytes>(st, dpt, ka, qa, va, da);
      // register i: key key0 + 8 ((i / 2) % 2), query q0 + col(i)
      auto col = [c0](int i) { return 8 * (i / 4) + c0 + (i % 2); };
      const bool diag = p.causal && kw0 + kHalf - 1 > q0;
      wgmma_wait<1>();  // S^T is ready; dP^T runs on
      fence_regs(st);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        st[i] = fast_exp2(fmaf(st[i], p.c, -lrow[col(i)]));
        if (diag && key0 + 8 * ((i / 2) % 2) > q0 + col(i)) st[i] = 0.f;
      }
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i)
        dpt[i] = st[i] * (dpt[i] - drow[col(i)]);
      uint32_t ph[kN / 16][4], pl[kN / 16][4], sh[kN / 16][4], sl[kN / 16][4];
      split_fragments<kN / 16>(st, ph, pl);
      split_fragments<kN / 16>(dpt, sh, sl);
      add_share<kSub, kN / 16, L::kBoxBytes>(dv, ph, pl, da);
      add_share<kSub, kN / 16, L::kBoxBytes>(dk, sh, sl, qa);
    }
    mbar_arrive(smem_addr(&empty[s]));
  }
  store_rows<kSub>(p.dk + b * p.sdk.b + hk * p.sdk.h, p.sdk.s, dk, key0, p.S,
                   p.scale, c0);
  store_rows<kSub>(p.dv + b * p.sdv.b + hk * p.sdv.h, p.sdv.s, dv, key0, p.S,
                   1.f, c0);
}

// (c) dQ of one (b, head, 128-query tile).  Thread 0 is also the
// producer: at key tile t it refills the stage of tile t - kLag, once both
// warpgroups are done with it, with tile t - kLag + kStages.
template <int D>
__global__ void __launch_bounds__(kConsumers, 1)
dq_wgmma_kernel(const __grid_constant__ Maps maps, WgArgs p) {
  using L = Wg<D, kKeyTile>;
  constexpr int kSub = L::kSub, kN = L::kN;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], own;
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int hk = h / (p.H / p.Hkv);
  // the longest causal rows first, so the tail of the grid is short
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
  const int n_kt = ((p.causal ? min(p.S, q0 + kOwn) : p.S) + kN - 1) / kN;
  init_ring(full, empty, own);

  // the producer's copy of key tile t
  auto issue = [&](int t) {
    const int s = t % kStages;
    const uint32_t bar = smem_addr(&full[s]);
    const uint32_t st = base + L::kRing + s * L::kStage;
    mbar_expect_tx(bar, L::kStage);
    for (int sub = 0; sub < kSub; ++sub) {
      tma_load(st + sub * L::kBoxBytes, &maps.k, bar, sub * kBox, t * kN, hk,
               b);
      tma_load(st + L::kTile + sub * L::kBoxBytes, &maps.v, bar, sub * kBox,
               t * kN, hk, b);
    }
  };
  const bool producer = threadIdx.x == 0;
  if (producer) {
    const uint32_t obar = smem_addr(&own);
    mbar_expect_tx(obar, 2 * L::kOwnTile);
    for (int sub = 0; sub < kSub; ++sub)
      for (int j = 0; j < kOwn / kN; ++j) {
        const uint32_t off = sub * L::kOwnSub + j * L::kBoxBytes;
        tma_load(base + L::kA + off, &maps.q, obar, sub * kBox, q0 + j * kN,
                 h, b);
        tma_load(base + L::kB + off, &maps.dout, obar, sub * kBox,
                 q0 + j * kN, h, b);
      }
    for (int t = 0; t < kStages && t < n_kt; ++t) issue(t);
  }

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int qw0 = q0 + wg * kHalf;  // this warpgroup's first query
  // this thread's queries (fragment rows): row0 and row0 + 8
  const int row0 = qw0 + (tid / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t qa = base + L::kA + wg * kHalf * kSwizzleRow;
  const uint32_t da = base + L::kB + wg * kHalf * kSwizzleRow;
  // padded rows: +inf and 0 past S, so those rows' P is 0
  const long long bh = static_cast<long long>(b) * p.H + h;
  const long long pad_row = bh * padded(p.S) + row0;
  const float lr[2] = {p.lse[pad_row], p.lse[pad_row + 8]};
  const float dr[2] = {p.delta[pad_row], p.delta[pad_row + 8]};

  float dq[kSub][32];
#pragma unroll
  for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[sub][i] = 0.f;

  mbar_wait(smem_addr(&own), 0);
  for (int t = 0; t < n_kt; ++t) {
    const int j = t - kLag + kStages;
    if (producer && t >= kLag && j < n_kt) {
      mbar_wait(smem_addr(&empty[(t - kLag) % kStages]),
                ((t - kLag) / kStages) & 1);
      issue(j);
    }
    __syncwarp();
    const int s = t % kStages;
    mbar_wait(smem_addr(&full[s]), (t / kStages) & 1);
    const int kt0 = t * kN;
    // a tile wholly after this warpgroup's queries adds nothing
    if (!p.causal || kt0 <= qw0 + kHalf - 1) {
      const uint32_t ka = base + L::kRing + s * L::kStage;
      const uint32_t va = ka + L::kTile;
      float sc[kN / 2], dp[kN / 2];
      issue_scores<D, kN, L::kOwnSub, L::kBoxBytes>(sc, dp, qa, ka, da, va);
      // register i: query row0 + 8 j (j = (i / 2) % 2), key kt0 + col;
      // keys past S or after the query are masked
      const bool edge = kt0 + kN > p.S || (p.causal && kt0 + kN - 1 > qw0);
      wgmma_wait<1>();  // S is ready; dP runs on
      fence_regs(sc);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int r = (i / 2) % 2;
        const int key = kt0 + 8 * (i / 4) + c0 + (i % 2);
        sc[i] = fast_exp2(fmaf(sc[i], p.c, -lr[r]));
        if (edge && (key >= p.S || (p.causal && key > row0 + 8 * r)))
          sc[i] = 0.f;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i)
        dp[i] = sc[i] * (dp[i] - dr[(i / 2) % 2]);
      uint32_t sh[kN / 16][4], sl[kN / 16][4];
      split_fragments<kN / 16>(dp, sh, sl);
      add_share<kSub, kN / 16, L::kBoxBytes>(dq, sh, sl, ka);
    }
    mbar_arrive(smem_addr(&empty[s]));
  }
  store_rows<kSub>(p.dq + b * p.sdq.b + h * p.sdq.h, p.sdq.s, dq, row0, p.S,
                   p.scale, c0);
}

// ------------------------------------------- f32: split-TF32 tensor route
// Tiles of the route (tf32.cuh): one warpgroup a block, owning 64 rows
// (keys in (b), queries in (c)), and streamed tiles of kN rows.
// Shared memory: the owned tiles (K and V in (b), Q and dO in (c)) hi and
// lo, the streamed tiles hi and lo as they are, then transposed (Q^T and
// dO^T in (b), K^T in (c)), then (b)'s lse and delta rows.
template <int D>
struct Tc {
  static constexpr int kThreads = 128;
  static constexpr int kOwn = 64;
  static constexpr int kN = 16;
  static constexpr int kDBox = (D + 31) / 32;   // box columns across D
  static constexpr int kCN = D < 64 ? D : 64;   // columns of a dK/dV/dQ chunk
  static constexpr int kOwnBox = kOwn * kSwizzleRow;
  static constexpr int kOwnTile = kDBox * kOwnBox;
  static constexpr int kNBox = kN * kSwizzleRow;
  static constexpr int kNTile = kDBox * kNBox;
  static constexpr int kTBox = D * kSwizzleRow;  // transposed: one box column
  static constexpr int kOwnA = 0, kOwnB = 2 * kOwnTile;
  static constexpr int kStr = 4 * kOwnTile;
  static constexpr int kTr = kStr + 4 * kNTile;
  static constexpr int kLse = kTr + 4 * kTBox;
  static constexpr int kBytesB = kLse + 2 * kN * 4;
  static constexpr int kBytesC = kTr + 2 * kTBox;
};

template <typename T>
struct Ptrs {
  const T *q, *k, *v, *dout;
  const float *lse, *delta;
  T *dq, *dk, *dv;
  float* parts;  // G > 1: each query head's dK, then its dV, (B, H, S, D)
};

// acc[c] += a b over one streamed tile: a the (hi, lo) fragments of its
// kSteps k8 steps, b the transposed tile at b_hi / b_lo, in chunks of kCN
// of its D rows.  Each chunk's share is summed on the tensor cores from
// zero, then added in f32.
template <bool kSplit, int kSteps, int D, int kNC, int kR>
__device__ __forceinline__ void add_tf32(float (&acc)[kNC][kR],
                                         const uint32_t (&hi)[kSteps][4],
                                         const uint32_t (&lo)[kSteps][4],
                                         uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int c = 0; c < kNC; ++c) {
    float part[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) part[i] = 0.f;
    const uint32_t rows = c * 2 * kR * kSwizzleRow;
    wgmma_fence();
    issue_rs<kSplit, kSteps, D * kSwizzleRow>(part, hi, lo, b_hi + rows,
                                              b_lo + rows);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < kR; ++i) acc[c][i] += part[i];
  }
}

// Store a warpgroup's 64 x D accumulator, times `mul`, as rows row0 and
// row0 + 8 of this thread (those below S), columns c0, c0 + 1 of each
// 8-wide chunk.
template <typename T, int kNC, int kR>
__device__ __forceinline__ void store_tc(T* base, long long rs,
                                         const float (&acc)[kNC][kR],
                                         int row0, int S, float mul, int c0) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + 8 * j;
    if (row >= S) continue;
    T* out = base + row * rs;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int n8 = 0; n8 < kR / 4; ++n8) {
        const int i = 4 * n8 + 2 * j;
        const int col = c * 2 * kR + 8 * n8 + c0;
        store(out + col, acc[c][i] * mul);
        store(out + col + 1, acc[c][i + 1] * mul);
      }
  }
}

// (b)'s streamed query tile of head h, rows from q0, into registers: Q
// and dO, and for the first kN threads that row's lse and delta (+inf
// and 0 past S, so those rows' P is 0 with no mask).
template <typename T, int D>
__device__ __forceinline__ void fetch_queries(
    const Ptrs<T>& p, const AllStrides& st, int b, int h, int H, int q0,
    int S, int tid, float (&qx)[Stage<Tc<D>::kN, D, Tc<D>::kThreads>::kPer],
    float (&dx)[Stage<Tc<D>::kN, D, Tc<D>::kThreads>::kPer], float& lv,
    float& dl) {
  constexpr int kN = Tc<D>::kN, NT = Tc<D>::kThreads;
  load_tile<kN, D, NT>(qx, p.q + b * st.q.b + h * st.q.h, st.q.s, q0, S, tid);
  load_tile<kN, D, NT>(dx, p.dout + b * st.dout.b + h * st.dout.h, st.dout.s,
                       q0, S, tid);
  if (tid < kN) {
    const int row = q0 + tid;
    const long long at = (static_cast<long long>(b) * H + h) * S + row;
    lv = row < S ? p.lse[at] : INFINITY;
    dl = row < S ? p.delta[at] : 0.f;
  }
}

// (b) one query head's share of dK and dV of one (b, KV head, kOwn-key
// tile), the longest causal tiles first: K and V staged once; the head's
// query tiles streamed from the first that reaches the tile's keys.  With
// one head a group the share is dK and dV; else it goes to p.parts, f32,
// and group_sum_kernel adds the group's shares in head order.
template <typename T, int D>
__global__ void __launch_bounds__(Tc<D>::kThreads, 1)
dkdv_tf32_kernel(Ptrs<T> p, AllStrides st, int H, int Hkv, int S, int causal,
                 float c, float scale) {
  using L = Tc<D>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kN = L::kN, kCN = L::kCN, kNC = D / kCN, NT = L::kThreads;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - smem_addr(smem_raw));
  float* ls = reinterpret_cast<float*>(sm + L::kLse);  // lse, then delta

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int group = H / Hkv, hk = h / group;
  const int k0 = blockIdx.y * L::kOwn;
  const int tid = threadIdx.x;
  {
    float x[Stage<L::kOwn, D, NT>::kPer];
    load_tile<L::kOwn, D, NT>(x, p.k + b * st.k.b + hk * st.k.h, st.k.s, k0,
                              S, tid);
    put_tile<kSplit, L::kOwn, D, NT>(x, sm + L::kOwnA,
                                     sm + L::kOwnA + L::kOwnTile, tid);
    load_tile<L::kOwn, D, NT>(x, p.v + b * st.v.b + hk * st.v.h, st.v.s, k0,
                              S, tid);
    put_tile<kSplit, L::kOwn, D, NT>(x, sm + L::kOwnB,
                                     sm + L::kOwnB + L::kOwnTile, tid);
  }
  const int qt0 = causal ? k0 / kN : 0;
  const int n_iter = (S + kN - 1) / kN - qt0;  // query tiles
  float qx[Stage<kN, D, NT>::kPer], dx[Stage<kN, D, NT>::kPer];
  float lv = 0.f, dl = 0.f;
  fetch_queries<T, D>(p, st, b, h, H, qt0 * kN, S, tid, qx, dx, lv, dl);

  const int lane = tid % 32;
  // this thread's keys (fragment rows): key0 and key0 + 8
  const int key0 = k0 + (tid / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);  // its first column of each 8-wide chunk
  const uint32_t qs = base + L::kStr, ds = qs + 2 * L::kNTile;
  const uint32_t qt = base + L::kTr, dt = qt + 2 * L::kTBox;

  float dk[kNC][kCN / 2], dv[kNC][kCN / 2];
#pragma unroll
  for (int cc = 0; cc < kNC; ++cc)
#pragma unroll
    for (int i = 0; i < kCN / 2; ++i) dk[cc][i] = dv[cc][i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int q0 = (qt0 + it) * kN;
    __syncthreads();  // the previous tile's products are done
    uint8_t* s0 = sm + L::kStr;
    put_tile<kSplit, kN, D, NT>(qx, s0, s0 + L::kNTile, tid);
    put_tile<kSplit, kN, D, NT>(dx, s0 + 2 * L::kNTile, s0 + 3 * L::kNTile,
                                tid);
    uint8_t* t0 = sm + L::kTr;
    put_tile_t<kSplit, kN, D, NT>(qx, t0, t0 + L::kTBox, tid);
    put_tile_t<kSplit, kN, D, NT>(dx, t0 + 2 * L::kTBox, t0 + 3 * L::kTBox,
                                  tid);
    if (tid < kN) {
      ls[tid] = lv;
      ls[kN + tid] = dl;
    }
    fence_async_smem();
    __syncthreads();
    if (it + 1 < n_iter)
      fetch_queries<T, D>(p, st, b, h, H, q0 + kN, S, tid, qx, dx, lv, dl);

    // S^T = K Q^T and dP^T = V dO^T, 64 keys x kN queries
    float sc[kN / 2], dp[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
    issue_ss<kSplit, D / 8, L::kOwnBox, L::kNBox>(
        sc, base + L::kOwnA, base + L::kOwnA + L::kOwnTile, qs,
        qs + L::kNTile);
    wgmma_commit();
    issue_ss<kSplit, D / 8, L::kOwnBox, L::kNBox>(
        dp, base + L::kOwnB, base + L::kOwnB + L::kOwnTile, ds,
        ds + L::kNTile);
    wgmma_commit();
    // register i: key key0 + 8 ((i / 2) % 2), query q0 + col(i)
    auto col = [c0](int i) { return 8 * (i / 4) + c0 + (i % 2); };
    const bool diag = causal && k0 + 63 > q0;
    wgmma_wait<1>();  // S^T is ready; dP^T runs on
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      sc[i] = exp2f(fmaf(sc[i], c, -ls[col(i)]));
      if (diag && key0 + 8 * ((i / 2) % 2) > q0 + col(i)) sc[i] = 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) dp[i] = sc[i] * (dp[i] - ls[kN + col(i)]);
    uint32_t fh[kN / 8][4], fl[kN / 8][4];
    a_fragments<kN / 8>(sc, fh, fl);
    add_tf32<kSplit, kN / 8, D>(dv, fh, fl, dt, dt + L::kTBox);
    a_fragments<kN / 8>(dp, fh, fl);
    add_tf32<kSplit, kN / 8, D>(dk, fh, fl, qt, qt + L::kTBox);
  }
  if (group == 1) {
    store_tc(p.dk + b * st.dk.b + hk * st.dk.h, st.dk.s, dk, key0, S, scale,
             c0);
    store_tc(p.dv + b * st.dv.b + hk * st.dv.h, st.dv.s, dv, key0, S, 1.f,
             c0);
  } else {
    const long long head = (static_cast<long long>(b) * H + h) * S * D;
    const long long all = static_cast<long long>(gridDim.x) * S * D;
    store_tc(p.parts + head, D, dk, key0, S, scale, c0);
    store_tc(p.parts + all + head, D, dv, key0, S, 1.f, c0);
  }
}

// dK and dV of a group of G > 1 query heads: each (b, KV head, s, d)
// element sums its heads' shares in head order, one thread an element.
template <typename T>
__global__ void __launch_bounds__(256)
group_sum_kernel(const float* __restrict__ parts, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int Hkv, int S, int D,
                 long long n, Strides sdk, Strides sdv) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= n) return;
  const int group = H / Hkv;
  const int d = static_cast<int>(i % D);
  const int s = static_cast<int>(i / D % S);
  const int hk = static_cast<int>(i / D / S % Hkv);
  const long long b = i / D / S / Hkv;
  const long long plane = static_cast<long long>(S) * D;
  const float* pk = parts + (b * H + hk * group) * plane + s * D + d;
  const float* pv = pk + n * group;  // the dV shares follow all dK shares
  float sk = 0.f, sv = 0.f;
  for (int g = 0; g < group; ++g) {
    sk += pk[g * plane];
    sv += pv[g * plane];
  }
  store(dk + b * sdk.b + hk * sdk.h + s * sdk.s + d, sk);
  store(dv + b * sdv.b + hk * sdv.h + s * sdv.s + d, sv);
}

// (c) dQ of one (b, head, kOwn-query tile), the longest causal rows
// first: Q and dO staged once; key tiles streamed up to the diagonal.
template <typename T, int D>
__global__ void __launch_bounds__(Tc<D>::kThreads, 1)
dq_tf32_kernel(Ptrs<T> p, AllStrides st, int H, int Hkv, int S, int causal,
               float c, float scale) {
  using L = Tc<D>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kN = L::kN, kCN = L::kCN, kNC = D / kCN, NT = L::kThreads;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - smem_addr(smem_raw));

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kOwn;
  const int tid = threadIdx.x;
  {
    float x[Stage<L::kOwn, D, NT>::kPer];
    load_tile<L::kOwn, D, NT>(x, p.q + b * st.q.b + h * st.q.h, st.q.s, q0,
                              S, tid);
    put_tile<kSplit, L::kOwn, D, NT>(x, sm + L::kOwnA,
                                     sm + L::kOwnA + L::kOwnTile, tid);
    load_tile<L::kOwn, D, NT>(x, p.dout + b * st.dout.b + h * st.dout.h,
                              st.dout.s, q0, S, tid);
    put_tile<kSplit, L::kOwn, D, NT>(x, sm + L::kOwnB,
                                     sm + L::kOwnB + L::kOwnTile, tid);
  }
  const T* kb = p.k + b * st.k.b + hk * st.k.h;
  const T* vb = p.v + b * st.v.b + hk * st.v.h;
  const int n_kt = ((causal ? min(S, q0 + L::kOwn) : S) + kN - 1) / kN;
  float kx[Stage<kN, D, NT>::kPer], vx[Stage<kN, D, NT>::kPer];
  load_tile<kN, D, NT>(kx, kb, st.k.s, 0, S, tid);
  load_tile<kN, D, NT>(vx, vb, st.v.s, 0, S, tid);

  const int lane = tid % 32;
  // this thread's queries (fragment rows): row0 and row0 + 8
  const int row0 = q0 + (tid / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t ks = base + L::kStr, vs = ks + 2 * L::kNTile;
  const uint32_t kt = base + L::kTr;
  // +inf and 0 past S, so those rows' P is 0
  const long long bh = static_cast<long long>(b) * H + h;
  float lr[2], dr[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + 8 * j;
    lr[j] = row < S ? p.lse[bh * S + row] : INFINITY;
    dr[j] = row < S ? p.delta[bh * S + row] : 0.f;
  }

  float dq[kNC][kCN / 2];
#pragma unroll
  for (int cc = 0; cc < kNC; ++cc)
#pragma unroll
    for (int i = 0; i < kCN / 2; ++i) dq[cc][i] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    __syncthreads();  // every warpgroup is done with the previous tile
    uint8_t* s0 = sm + L::kStr;
    put_tile<kSplit, kN, D, NT>(kx, s0, s0 + L::kNTile, tid);
    put_tile<kSplit, kN, D, NT>(vx, s0 + 2 * L::kNTile, s0 + 3 * L::kNTile,
                                tid);
    put_tile_t<kSplit, kN, D, NT>(kx, sm + L::kTr, sm + L::kTr + L::kTBox,
                                  tid);
    fence_async_smem();
    __syncthreads();
    const int kt0 = t * kN;
    if (t + 1 < n_kt) {
      load_tile<kN, D, NT>(kx, kb, st.k.s, kt0 + kN, S, tid);
      load_tile<kN, D, NT>(vx, vb, st.v.s, kt0 + kN, S, tid);
    }

    // S = Q K^T and dP = dO V^T, 64 queries x kN keys
    float sc[kN / 2], dp[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
    issue_ss<kSplit, D / 8, L::kOwnBox, L::kNBox>(
        sc, base + L::kOwnA, base + L::kOwnA + L::kOwnTile, ks,
        ks + L::kNTile);
    wgmma_commit();
    issue_ss<kSplit, D / 8, L::kOwnBox, L::kNBox>(
        dp, base + L::kOwnB, base + L::kOwnB + L::kOwnTile, vs,
        vs + L::kNTile);
    wgmma_commit();
    // register i: query row0 + 8 ((i / 2) % 2), key kt0 + col; keys past
    // S or after the query are masked
    const bool edge = kt0 + kN > S || (causal && kt0 + kN - 1 > q0);
    wgmma_wait<1>();  // S is ready; dP runs on
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const int r = (i / 2) % 2;
      const int key = kt0 + 8 * (i / 4) + c0 + (i % 2);
      sc[i] = exp2f(fmaf(sc[i], c, -lr[r]));
      if (edge && (key >= S || (causal && key > row0 + 8 * r))) sc[i] = 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) dp[i] = sc[i] * (dp[i] - dr[(i / 2) % 2]);
    uint32_t fh[kN / 8][4], fl[kN / 8][4];
    a_fragments<kN / 8>(dp, fh, fl);
    add_tf32<kSplit, kN / 8, D>(dq, fh, fl, kt, kt + L::kTBox);
  }
  store_tc(p.dq + b * st.dq.b + h * st.dq.h, st.dq.s, dq, row0, S, scale,
           c0);
}
// --------------------------------------------------------------- launches
struct Problem {
  int B, H, Hkv, S, D, causal;
  float scale;
  Strides o;
  AllStrides st;
};

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta,
                 const Problem& pr, cudaStream_t stream) {
  const long long rows = static_cast<long long>(pr.B) * pr.H * pr.S;
  const unsigned blocks = static_cast<unsigned>((rows + 255) / 256);
  delta_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, pr.H,
      pr.S, pr.D, rows, pr.o, pr.st.dout);
  return static_cast<int>(cudaGetLastError());
}

// The row pass, dK/dV and dQ of the wgmma route.  scratch holds lse's
// padded copy, then delta: 2 B H Sp f32.
// The four operands' tensor maps with boxes of 64 x rows.
bool encode_maps(EncodeTiled fn, Maps* maps, const void* q, const void* k,
                 const void* v, const void* dout, int D, int rows,
                 const Problem& pr) {
  const AllStrides& st = pr.st;
  return encode(fn, &maps->q, q, pr.B, pr.H, pr.S, D, st.q, rows) &&
         encode(fn, &maps->k, k, pr.B, pr.Hkv, pr.S, D, st.k, rows) &&
         encode(fn, &maps->v, v, pr.B, pr.Hkv, pr.S, D, st.v, rows) &&
         encode(fn, &maps->dout, dout, pr.B, pr.H, pr.S, D, st.dout, rows);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* scratch, void* dq,
                 void* dk, void* dv, const Problem& pr, cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Maps query_maps, key_maps;  // boxes of (b)'s and (c)'s streamed tiles
  if (!encode_maps(fn, &query_maps, q, k, v, dout, D, kQueryTile<D>, pr) ||
      !encode_maps(fn, &key_maps, q, k, v, dout, D, kKeyTile, pr))
    return static_cast<int>(cudaErrorInvalidPitchValue);
  const AllStrides& st = pr.st;
  const int Sp = padded(pr.S);
  const long long rows = static_cast<long long>(pr.B) * pr.H * Sp;
  float* lse_pad = scratch;
  float* delta_pad = scratch + rows;
  row_pass_kernel<D><<<static_cast<unsigned>(rows * kRowLanes / 256), 256, 0,
                       stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, lse_pad, delta_pad, pr.H,
      pr.S, Sp, rows, pr.o, st.dout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // + alignment slack
  constexpr int query_smem = Wg<D, kQueryTile<D>>::kBytes + 1024;
  constexpr int key_smem = Wg<D, kKeyTile>::kBytes + 1024;
  err = cudaFuncSetAttribute(dkdv_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             query_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             key_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const WgArgs args{lse_pad, delta_pad,
                    static_cast<__nv_bfloat16*>(dq),
                    static_cast<__nv_bfloat16*>(dk),
                    static_cast<__nv_bfloat16*>(dv),
                    st.dq, st.dk, st.dv, pr.H, pr.Hkv, pr.S, pr.causal,
                    pr.scale * kLog2e, pr.scale};
  const unsigned tiles = static_cast<unsigned>(Sp / kOwn);
  dkdv_wgmma_kernel<D><<<dim3(pr.B * pr.Hkv, tiles), kConsumers + 32,
                         query_smem, stream>>>(query_maps, args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_wgmma_kernel<D><<<dim3(pr.B * pr.H, tiles), kConsumers, key_smem,
                       stream>>>(key_maps, args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_tc(const Ptrs<T>& p, const Problem& pr, cudaStream_t stream) {
  using L = Tc<D>;
  constexpr int smem_b = L::kBytesB + 1024;  // + alignment slack
  constexpr int smem_c = L::kBytesC + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_tf32_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_tf32_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = static_cast<unsigned>((pr.S + L::kOwn - 1) / L::kOwn);
  const float c = pr.scale * kLog2e;
  dkdv_tf32_kernel<T, D><<<dim3(pr.B * pr.H, tiles), L::kThreads, smem_b,
                           stream>>>(p, pr.st, pr.H, pr.Hkv, pr.S, pr.causal,
                                     c, pr.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pr.H != pr.Hkv) {
    const long long n = static_cast<long long>(pr.B) * pr.Hkv * pr.S * pr.D;
    group_sum_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                          stream>>>(p.parts, p.dk, p.dv, pr.H, pr.Hkv, pr.S,
                                    pr.D, n, pr.st.dk, pr.st.dv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dq_tf32_kernel<T, D><<<dim3(pr.B * pr.H, tiles), L::kThreads, smem_c,
                         stream>>>(p, pr.st, pr.H, pr.Hkv, pr.S, pr.causal, c,
                                   pr.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int tc_dispatch(const Ptrs<T>& p, const Problem& pr, cudaStream_t stream) {
  switch (pr.D) {
    case 8: return launch_tc<T, 8>(p, pr, stream);
    case 16: return launch_tc<T, 16>(p, pr, stream);
    case 32: return launch_tc<T, 32>(p, pr, stream);
    case 64: return launch_tc<T, 64>(p, pr, stream);
    case 128: return launch_tc<T, 128>(p, pr, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Problem problem(int B, int H, int Hkv, int S, int D, const long long* s,
                int causal, float scale) {
  auto at = [s](int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; };
  return Problem{B, H, Hkv, S, D, causal, scale, at(3),
                 AllStrides{at(0), at(1), at(2), at(4), at(5), at(6), at(7)}};
}

}  // namespace

// q, o, dout, dq: (B, H, S, D); k, v, dk, dv: (B, Hkv, S, D), each
// addressed through (batch, head, seq) strides in elements, D contiguous;
// the strides come in the order q, k, v, o, dout, dq, dk, dv.  lse (the
// forward's, base 2) is (B, H, S) f32 contiguous.  dq, dk and dv are
// written whole.

// bf16 at D 64 or 128: q, k, v, o and dout need 16-byte aligned bases and
// strides (of the dims longer than 1) that are multiples of 8 elements.
// delta is scratch of 2 B H Sp f32, Sp = S rounded up to a multiple of
// 128, written here.
extern "C" int flash_attention_backward_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Hkv, int S, int D, long long sqb,
    long long sqh, long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, long long sob, long long soh,
    long long sos, long long sdob, long long sdoh, long long sdos,
    long long sdqb, long long sdqh, long long sdqs, long long sdkb,
    long long sdkh, long long sdks, long long sdvb, long long sdvh,
    long long sdvs, int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const long long s[24] = {sqb,  sqh,  sqs,  skb,  skh,  sks,  svb,  svh,
                           svs,  sob,  soh,  sos,  sdob, sdoh, sdos, sdqb,
                           sdqh, sdqs, sdkb, sdkh, sdks, sdvb, sdvh, sdvs};
  const Problem pr = problem(B, H, Hkv, S, D, s, causal, scale);
  auto st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  float* scratch = static_cast<float*>(delta);
  return D == 64 ? launch_wgmma<64>(q, k, v, o, dout, ls, scratch, dq, dk,
                                    dv, pr, st)
                 : launch_wgmma<128>(q, k, v, o, dout, ls, scratch, dq, dk,
                                     dv, pr, st);
}

// The split-TF32 route: dtype 0 float32, 1 bfloat16; D in {8, 16, 32, 64,
// 128}; any strides with D contiguous.  delta is scratch written here: B H
// S f32 (delta), then, when H > Hkv, 2 B H S D f32 (each query head's
// share of dK, then of dV).
extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int H, int Hkv, int S, int D, long long sqb,
    long long sqh, long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, long long sob, long long soh,
    long long sos, long long sdob, long long sdoh, long long sdos,
    long long sdqb, long long sdqh, long long sdqs, long long sdkb,
    long long sdkh, long long sdks, long long sdvb, long long sdvh,
    long long sdvs, int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D != 8 && D != 16 && D != 32 && D != 64 && D != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long s[24] = {sqb,  sqh,  sqs,  skb,  skh,  sks,  svb,  svh,
                           svs,  sob,  soh,  sos,  sdob, sdoh, sdos, sdqb,
                           sdqh, sdqs, sdkb, sdkh, sdks, sdvb, sdvh, sdvs};
  const Problem pr = problem(B, H, Hkv, S, D, s, causal, scale);
  auto st = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  float* parts = dl + static_cast<long long>(B) * H * S;
  const float* ls = static_cast<const float*>(lse);
  if (dtype == 0) {
    const int err = launch_delta<float>(o, dout, dl, pr, st);
    if (err != 0) return err;
    return tc_dispatch<float>(
        Ptrs<float>{static_cast<const float*>(q),
                          static_cast<const float*>(k),
                          static_cast<const float*>(v),
                          static_cast<const float*>(dout), ls, dl,
                          static_cast<float*>(dq), static_cast<float*>(dk),
                          static_cast<float*>(dv), parts},
        pr, st);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    const int err = launch_delta<bf>(o, dout, dl, pr, st);
    if (err != 0) return err;
    return tc_dispatch<bf>(
        Ptrs<bf>{static_cast<const bf*>(q), static_cast<const bf*>(k),
                       static_cast<const bf*>(v),
                       static_cast<const bf*>(dout), ls, dl,
                       static_cast<bf*>(dq), static_cast<bf*>(dk),
                       static_cast<bf*>(dv), parts},
        pr, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
